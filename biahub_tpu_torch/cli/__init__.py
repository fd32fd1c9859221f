"""The port's command line: ``python -m biahub_tpu_torch.cli <verb> ...``
(:mod:`biahub_tpu_torch.cli.main`)."""

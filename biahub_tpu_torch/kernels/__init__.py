"""Kernels of the port: CUDA sources in ``biahub_tpu_torch/csrc``, each
wrapped with its plain PyTorch version and a launch counter
(:data:`biahub_tpu_torch.kernels._build.launch_counts`)."""

"""Execution runtime: the work units' ownership across processes
(:func:`~biahub_tpu_torch.runtime.executor.stripe_units`)."""

from biahub_tpu_torch.runtime.executor import stripe_units

__all__ = ["stripe_units"]

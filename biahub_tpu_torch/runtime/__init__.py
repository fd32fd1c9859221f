"""Execution runtime: the batch runner (:mod:`~biahub_tpu_torch.runtime.
executor`), resource estimates and the resume token
(:mod:`~biahub_tpu_torch.runtime.resources`), per-batch timing lines and
device traces (:mod:`~biahub_tpu_torch.runtime.profiling`)."""

from biahub_tpu_torch.runtime.executor import (
    BatchRunner,
    resolve_cluster,
    sbatch_to_overrides,
    stripe_units,
)
from biahub_tpu_torch.runtime.resources import (
    echo_resources,
    estimate_resources,
    settings_fingerprint,
)

__all__ = [
    "BatchRunner",
    "echo_resources",
    "estimate_resources",
    "resolve_cluster",
    "sbatch_to_overrides",
    "settings_fingerprint",
    "stripe_units",
]

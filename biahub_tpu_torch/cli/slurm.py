"""Blocking wait over job-like objects.

Counterpart of ``biahub_tpu/cli/slurm.py``: the runner's jobs and
``concurrent.futures`` futures alike.
"""

from __future__ import annotations

import time

__all__ = ["wait_for_jobs_to_finish"]


def wait_for_jobs_to_finish(jobs, poll_seconds: float = 1.0) -> None:
    """Block until every job reports done; a job without ``done`` counts as
    done."""
    remaining = list(jobs)
    while remaining:
        still = []
        for job in remaining:
            done = getattr(job, "done", None)
            if done is not None and not done():
                still.append(job)
        if len(still) != len(remaining):
            print(f"{len(jobs) - len(still)}/{len(jobs)} jobs finished")
        remaining = still
        if remaining:
            time.sleep(poll_seconds)

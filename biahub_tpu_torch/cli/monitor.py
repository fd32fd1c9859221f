"""The ``--monitor`` job table.

Counterpart of ``biahub_tpu/cli/monitor.py``: a live table of the runner's
per-position jobs (``runtime.executor.PositionJob``) until all are done;
ctrl-C cancels them (the run stops at the next batch boundary) and
re-raises; at the end the first failure's error is printed.
"""

from __future__ import annotations

import sys
import time

__all__ = ["monitor_jobs", "JobLike"]

_TERMINAL = ("DONE", "COMPLETED", "FAILED", "CANCELLED")


class JobLike:
    """Minimal job facade: a named state machine with done()/cancel()."""

    def __init__(self, name: str):
        self.name = name
        self.state = "PENDING"
        self.error: str | None = None

    def done(self) -> bool:
        return self.state in _TERMINAL

    def cancel(self) -> None:
        if not self.done():
            self.state = "CANCELLED"


def _render(jobs, names, clear: bool = True) -> list[str]:
    states = []
    for job in jobs:
        state = getattr(job, "state", None)
        if state is None:
            state = "DONE" if getattr(job, "done", lambda: True)() else "RUNNING"
        states.append(str(state))
    lines = [f"{name:<50} {state}" for name, state in zip(names, states)]
    prefix = "\x1b[2J\x1b[H" if clear else ""
    sys.stdout.write(prefix + "\n".join(lines) + "\n")
    sys.stdout.flush()
    return states


def monitor_jobs(jobs, names, poll_seconds: float = 1.0, clear: bool = True) -> None:
    """Render a live table of job states until every job is terminal."""
    jobs = list(jobs)
    names = [str(n) for n in names] or [f"job-{i}" for i in range(len(jobs))]
    try:
        while True:
            states = _render(jobs, names, clear=clear)
            if all(s in _TERMINAL for s in states):
                break
            time.sleep(poll_seconds)
    except KeyboardInterrupt:
        print("Cancelling jobs...")
        for job in jobs:
            cancel = getattr(job, "cancel", None)
            if cancel:
                cancel()
        raise
    failed = [j for j in jobs if getattr(j, "state", "") == "FAILED"]
    if failed:
        print(f"Failed jobs: {[getattr(j, 'name', '?') for j in failed]}")
        first_error = getattr(failed[0], "error", None)
        if first_error:
            print(f"First failure ({getattr(failed[0], 'name', '?')}):")
            print(str(first_error))

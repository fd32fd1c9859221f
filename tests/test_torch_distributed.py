"""biahub_tpu_torch's process group, barrier and work striping.

Two processes on gloo, started with the reference's variables
(``BIAHUB_TPU_COORDINATOR``, ``BIAHUB_TPU_NUM_PROCESSES``,
``BIAHUB_TPU_PROCESS_ID``) on a free localhost port; each imports torch and
the port only. A test kills its processes and fails after its own limit
(LIMIT_S), never waiting on the group's default timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from biahub_tpu_torch.parallel import distributed
from biahub_tpu_torch.runtime.executor import stripe_units

LIMIT_S = 60
BARRIER_TIMEOUT_S = 3
N_UNITS = 11

# One process of the group: mode "pass" meets at the barrier; mode "skip"
# has process 1 skip it (it sleeps past the timeout, then leaves).
WORKER = f"""
import json, sys, time
from biahub_tpu_torch.parallel import distributed as d
from biahub_tpu_torch.runtime.executor import stripe_units

mode = sys.argv[1]
out = {{"multi": d.maybe_initialize_distributed()}}
out.update(index=d.process_index(), count=d.process_count(),
           coordinator=d.is_coordinator(), share=stripe_units(range({N_UNITS})))
if mode == "skip" and d.process_index() == 1:
    time.sleep({2 * BARRIER_TIMEOUT_S})
    out["barrier"] = "skipped"
else:
    t0 = time.monotonic()
    try:
        d.barrier("test")
        out["barrier"] = "passed"
    except RuntimeError as exc:
        out["barrier"] = str(exc)
    out["seconds"] = time.monotonic() - t0
    out["adopted"] = d.maybe_initialize_distributed()
print("RESULT " + json.dumps(out), flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(mode: str) -> list[dict]:
    """Both processes' results, by rank."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, BIAHUB_TPU_COORDINATOR=f"tcp://localhost:{port}",
                   BIAHUB_TPU_NUM_PROCESSES="2", BIAHUB_TPU_PROCESS_ID=str(rank),
                   BIAHUB_TPU_BARRIER_TIMEOUT_S=str(BARRIER_TIMEOUT_S))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, mode], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    deadline = time.monotonic() + LIMIT_S
    outputs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            outputs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the process group did not finish within {LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rc, out, err in outputs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert rc == 0 and lines, f"rc {rc}\n{out}\n{err}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


def test_two_processes_stripe_the_units_and_meet_at_the_barrier():
    results = run_group("pass")
    assert [r["index"] for r in results] == [0, 1]
    assert all(r["count"] == 2 and r["multi"] and r["adopted"] for r in results)
    assert [r["coordinator"] for r in results] == [True, False]
    shares = [r["share"] for r in results]
    assert shares == [list(range(N_UNITS))[i::2] for i in range(2)]
    assert sorted(shares[0] + shares[1]) == list(range(N_UNITS))
    assert all(r["barrier"] == "passed" for r in results)


def test_barrier_times_out_when_a_peer_skips_it():
    waiting, skipping = run_group("skip")
    assert skipping["barrier"] == "skipped"
    assert "timed out after 3 s" in waiting["barrier"], waiting["barrier"]
    assert BARRIER_TIMEOUT_S - 0.5 <= waiting["seconds"] <= 2 * BARRIER_TIMEOUT_S


def test_one_process_without_coordinates(monkeypatch):
    for name in ("BIAHUB_TPU_COORDINATOR", "BIAHUB_TPU_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_coordinator()
    distributed.barrier("alone", timeout_s=0.01)  # a no-op in one process
    assert stripe_units(range(5)) == list(range(5))


def test_incomplete_coordinates_raise(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_COORDINATOR", "localhost:1")
    monkeypatch.delenv("BIAHUB_TPU_PROCESS_ID", raising=False)
    monkeypatch.setenv("BIAHUB_TPU_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="process coordinates are incomplete"):
        distributed.maybe_initialize_distributed()

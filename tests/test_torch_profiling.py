"""biahub_tpu_torch's timing lines and device traces (runtime/profiling.py).

``summarize_device_trace`` reads a small gzipped Chrome trace written here
(the events ``torch.profiler`` writes: CUDA kernels, memcpys and memsets
beside host events) as the reference's test reads its TPU trace;
``profiled_section`` prints its wall line under ``BIAHUB_TPU_PROFILE=1``
and, with a directory, writes a ``*.trace.json.gz`` there (CPU activity
here) and prints the table; the command line runs each verb inside it.
"""

import gzip
import json

import numpy as np
import pytest

from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.runtime.profiling import profiled_section, summarize_device_trace


def write_trace(path, events) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "blend_kernel", "pid": 0, "tid": 7, "ts": 0,
     "dur": 2000},
    {"ph": "X", "cat": "kernel", "name": "blend_kernel", "pid": 0, "tid": 7, "ts": 5,
     "dur": 1000},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0,
     "tid": 7, "ts": 9, "dur": 500},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7, "ts": 9,
     "dur": 250},
    {"ph": "X", "cat": "cpu_op", "name": "aten::einsum", "pid": 1, "tid": 1, "ts": 0,
     "dur": 9999},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 0,
     "dur": 30},
    {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7, "ts": 3},
]


def test_summarize_device_trace(tmp_path, capsys):
    write_trace(tmp_path / "20240101_000000_1.host_1.pt.trace.json.gz",
                [dict(EVENTS[0], name="older_kernel")])
    write_trace(tmp_path / "nested" / "20250101_000000_1.host_1.pt.trace.json.gz", EVENTS)
    rows = summarize_device_trace(str(tmp_path), top=2)
    assert rows == [("blend_kernel", 3.0, 2), ("Memcpy HtoD (Pageable -> Device)", 0.5, 1),
                    ("Memset (Device)", 0.25, 1)]
    err = capsys.readouterr().err
    assert "device time by op" in err and "blend_kernel" in err and "Memset" not in err
    with pytest.raises(FileNotFoundError, match="no \\*.trace.json.gz"):
        summarize_device_trace(str(tmp_path / "empty"))


def test_profiled_section_prints_its_wall_time(monkeypatch, capsys, tmp_path):
    monkeypatch.delenv("BIAHUB_TPU_PROFILE", raising=False)
    with profiled_section("quiet"):
        pass
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("BIAHUB_TPU_PROFILE", "1")
    with profiled_section("stitch"):
        pass
    err = capsys.readouterr().err
    assert err.startswith("[biahub-tpu profile] stitch: ") and err.strip().endswith("s")
    assert not list(tmp_path.iterdir())


def test_a_verb_under_a_trace_directory_writes_its_trace(monkeypatch, capsys, tmp_path):
    plate = open_ome_zarr(tmp_path / "p.zarr", layout="hcs", mode="w", channel_names=["a"])
    plate.create_position("A", "1", "0").create_image("0", np.ones((1, 1, 2, 4, 6), np.float32))
    monkeypatch.setenv("BIAHUB_TPU_PROFILE", str(tmp_path / "trace"))
    assert main(["flip", "-i", str(tmp_path / "p.zarr/A/1/0"), "-x"], device="cpu") == 0
    traces = list((tmp_path / "trace").glob("*.trace.json.gz"))
    assert len(traces) == 1
    with gzip.open(traces[0]) as f:
        assert "traceEvents" in json.load(f)
    err = capsys.readouterr().err
    assert "[biahub-tpu profile] flip: " in err and "device time by op" in err
    assert summarize_device_trace(str(tmp_path / "trace")) == []  # no card, no device rows

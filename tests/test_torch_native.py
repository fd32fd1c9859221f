"""The port's compiled host helper (``biahub_tpu_torch/_native``) against its
Python loops and biahub_tpu's.

``lir_2d`` equals the port's loop (``largest_interior_rectangle_plain``)
and the reference's ``lir`` with its own helper on and off, on random
masks, exactly (integers). ``edge_consistency_costs`` equals the port's
vectorised ``sorted_assignment_costs`` (cast to its float32) and the
reference's helper and loop (float64), exactly: the same DP in the same
order. Skipped only where no C++ compiler is found.
"""

import os
import shutil

import numpy as np
import pytest

import biahub_tpu._native
from biahub_tpu.transforms import graph_matching as jgm
from biahub_tpu.transforms import lir as jlir
from biahub_tpu_torch import _native
from biahub_tpu_torch.register import find_lir
from biahub_tpu_torch.transforms import graph_matching as tgm
from biahub_tpu_torch.transforms import lir as tlir


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no C++ compiler to build biahub_tpu_torch/_native/fastops.cpp")


@pytest.fixture
def reference_native(monkeypatch, tmp_path):
    """The reference's helper, built into a folder of the test's."""
    monkeypatch.setenv("BIAHUB_TPU_NATIVE_CACHE", str(tmp_path))
    monkeypatch.delenv("BIAHUB_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(biahub_tpu._native, "_LIB", None)
    monkeypatch.setattr(biahub_tpu._native, "_TRIED", False)
    assert biahub_tpu._native.get_lib() is not None


def random_masks(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        shape = tuple(rng.integers(1, 48, 2))
        yield rng.random(shape) < rng.uniform(0.5, 0.97)
    # A warped frame's footprint, and the empty and full masks.
    yy, xx = np.mgrid[:60, :45]
    yield (yy + 0.3 * xx > 8) & (yy - 0.4 * xx < 40) & (xx > 3)
    yield np.zeros((7, 9), bool)
    yield np.ones((5, 13), bool)


@pytest.mark.parametrize("seed", [0, 1])
def test_lir_2d_equals_the_loop_and_the_reference(seed, reference_native, monkeypatch):
    masks = list(random_masks(seed))
    native_ref = [jlir.lir(m) for m in masks]
    monkeypatch.setattr(biahub_tpu._native, "lir_2d", lambda mask: None)
    loop_ref = [jlir.lir(m) for m in masks]
    for mask, with_helper, with_loop in zip(masks, native_ref, loop_ref):
        got = _native.lir_2d(mask)
        assert got == tlir.largest_interior_rectangle_plain(mask)
        assert got == tlir.largest_interior_rectangle(mask) == tlir.lir(mask)
        assert got == tuple(with_helper) == tuple(with_loop)


def test_find_lir_equals_the_loop():
    rng = np.random.default_rng(3)
    vol = np.ones((9, 40, 30), bool)
    vol[:, :3] = vol[:, :, -4:] = False
    vol[:2, :, :7] = vol[-1] = False
    vol &= rng.random(vol.shape) < 0.995
    got = find_lir(vol)
    with pytest.MonkeyPatch.context() as mp:
        import biahub_tpu_torch.register as treg

        mp.setattr(treg, "largest_interior_rectangle", tlir.largest_interior_rectangle_plain)
        assert find_lir(vol) == got


def test_lir_2d_refuses_other_ranks():
    with pytest.raises(ValueError, match="2D mask"):
        _native.lir_2d(np.ones((2, 3, 4), bool))


@pytest.mark.parametrize("default_cost", [1e6, np.pi])
def test_edge_consistency_costs_equal_the_vectorised_dp_and_the_reference(
        default_cost, reference_native):
    rng = np.random.default_rng(4)
    mov = [np.sort(rng.random(n) * 30) for n in rng.integers(0, 9, 40)]
    ref = [np.sort(rng.random(n) * 30) for n in rng.integers(0, 9, 35)]
    got = _native.edge_consistency_costs(mov, ref, default_cost)
    assert got.dtype == np.float64 and got.shape == (40, 35)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  tgm.sorted_assignment_costs(mov, ref, default_cost))
    np.testing.assert_array_equal(
        got, biahub_tpu._native.edge_consistency_costs(mov, ref, default_cost))
    for i, a in enumerate(mov):
        for j, b in enumerate(ref):
            want = default_cost if not len(a) or not len(b) else jgm._sorted_assignment_cost(a, b)
            assert got[i, j] == want


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_BUILD", tmp_path)
    monkeypatch.setattr(_native, "CXX_FLAGS", _native.CXX_FLAGS + ("--no-such-option",))
    with pytest.raises(RuntimeError, match="failed"):
        _native.lir_2d(np.ones((3, 3), bool))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        _native.lir_2d(np.ones((3, 3), bool))
    assert not list(tmp_path.glob("*.so"))

"""biahub_tpu_torch's chunked warps against biahub_tpu's on the same inputs.

``chunked_affine_warp_zyx`` dispatches each output chunk as each package's
``affine_warp_auto`` does. Off the accelerator the reference takes its
exact gather for general matrices (affine.py:609-625) while the port always
takes the multipass warp, so general matrices are held against the
reference's ``multipass_affine_warp_zyx_chunked``, and against the
reference's ``chunked_affine_warp_zyx`` with its accelerator dispatch
patched in. Translation, in-plane and order-0 matrices are held against the
reference's ``chunked_affine_warp_zyx`` as it runs here. Tolerances: the
chunk boxes (slices) equal; values within 1e-5 of max |ref| (the warps'
envelope); order 0 equal.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels import multipass_warp as jmw
from biahub_tpu_torch.kernels import affine as taf
from biahub_tpu_torch.kernels import multipass_warp as tmw

RTOL = 1e-5
IN_SHAPE = (20, 40, 36)
OUT_SHAPE = (18, 42, 34)
CHUNK = (9, 21, 17)


def volume() -> np.ndarray:
    return np.random.default_rng(0).random(IN_SHAPE).astype(np.float32)


def about_centre(angles_zyx_deg, shift) -> np.ndarray:
    m = np.eye(4)
    r = Rotation.from_euler("zyx", angles_zyx_deg, degrees=True).as_matrix()
    c = (np.asarray(IN_SHAPE, float) - 1) / 2
    m[:3, :3] = r
    m[:3, 3] = c - r @ c + np.asarray(shift, float)
    return m


MATRICES = {
    "translation": np.array([[1, 0, 0, 0.7], [0, 1, 0, -2.3], [0, 0, 1, 1.2], [0, 0, 0, 1.0]]),
    "inplane": about_centre([0, 0, 5], [0.3, -1.1, 0.8]),
    "general": about_centre([0, 3, 5], [0.3, -1.1, 0.8]),
    "quarter_turn": about_centre([0, 0, 90], [0.0, 0.0, 0.0]),
}


def assemble(pairs) -> tuple[list, np.ndarray]:
    out = np.zeros(OUT_SHAPE, np.float32)
    for sl, chunk in pairs:
        out[sl] = np.asarray(chunk)
    return [sl for sl, _ in pairs], out


def accelerator_warp(vol, matrix, output_shape, fill=0.0, order=1, input_xzy=False):
    """The reference's affine_warp_auto as it dispatches on the accelerator
    (affine.py:609-623): general order-1 matrices to the multipass warp."""
    m = np.asarray(matrix, dtype=np.float64)
    if order == 1 and not jaff.is_inplane_matrix(m):
        try:
            return jmw.multipass_affine_warp_zyx(vol, m, tuple(output_shape), fill=fill)
        except ValueError:
            pass
    return reference_auto(vol, m, output_shape, fill=fill, order=order, input_xzy=input_xzy)


reference_auto = jaff.affine_warp_auto


@pytest.mark.parametrize("order", [1, 0])
@pytest.mark.parametrize("name", ["translation", "inplane", "quarter_turn"])
def test_chunked_affine_warp_matches_reference(name, order):
    vol = volume()

    def read(zs, ys, xs):
        return vol[zs, ys, xs]

    m = MATRICES[name]
    want_sl, want = assemble(jmw.chunked_affine_warp_zyx(read, m, IN_SHAPE, OUT_SHAPE, CHUNK,
                                                         order=order))
    got_sl, got = assemble(tmw.chunked_affine_warp_zyx(read, m, IN_SHAPE, OUT_SHAPE, CHUNK,
                                                       order=order, device="cpu"))
    assert got_sl == want_sl
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_chunked_general_warp_matches_reference_multipass(fill, monkeypatch):
    vol = volume()
    m = MATRICES["general"]

    def read(zs, ys, xs):
        return vol[zs, ys, xs]

    want_sl, want = assemble(jmw.multipass_affine_warp_zyx_chunked(
        read, m, IN_SHAPE, OUT_SHAPE, CHUNK, fill=fill))
    got_sl, got = assemble(tmw.multipass_affine_warp_zyx_chunked(
        read, m, IN_SHAPE, OUT_SHAPE, CHUNK, fill=fill, device="cpu"))
    assert got_sl == want_sl
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    # The dispatching warp takes the same multipass chunks once the
    # reference dispatches as on the accelerator.
    monkeypatch.setattr(jaff, "affine_warp_auto", accelerator_warp)
    _, want_auto = assemble(jmw.chunked_affine_warp_zyx(read, m, IN_SHAPE, OUT_SHAPE, CHUNK,
                                                        fill=fill))
    _, got_auto = assemble(tmw.chunked_affine_warp_zyx(read, m, IN_SHAPE, OUT_SHAPE, CHUNK,
                                                       fill=fill, device="cpu"))
    assert np.abs(got_auto - want_auto).max() <= RTOL * np.abs(want_auto).max()
    np.testing.assert_array_equal(got_auto, got)


@pytest.mark.parametrize("name", ["translation", "inplane"])
def test_chunks_agree_with_the_whole_warp(name):
    """Translation and in-plane chunks equal the port's whole-volume warp
    within the warps' envelope, and write_fn sees every chunk once."""
    vol = volume()
    m = MATRICES[name]
    whole = taf.affine_warp_auto(vol, m, OUT_SHAPE, device="cpu").numpy()
    got = torch.full(OUT_SHAPE, float("nan"))

    def write(zs, ys, xs, chunk):
        assert torch.isnan(got[zs, ys, xs]).all()
        got[zs, ys, xs] = chunk

    assert tmw.chunked_affine_warp_zyx(lambda zs, ys, xs: torch.from_numpy(vol)[zs, ys, xs],
                                       m, IN_SHAPE, OUT_SHAPE, CHUNK, write_fn=write,
                                       device="cpu") is None
    assert np.abs(got.numpy() - whole).max() <= RTOL * np.abs(whole).max()


def test_chunked_warps_need_a_card_by_default():
    vol = volume()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmw.chunked_affine_warp_zyx(lambda *s: vol[s], MATRICES["inplane"], IN_SHAPE,
                                    OUT_SHAPE, CHUNK)

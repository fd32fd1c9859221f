"""biahub_tpu_torch's sharded FFT against biahub_tpu's, and against itself.

The port runs its plain PyTorch versions here on a virtual CPU mesh
(``Mesh.virtual("cpu", n)``: n shards on the one CPU device); the reference
runs its Pallas passes in interpret mode under ``shard_map`` on the
conftest's 8 virtual CPU devices, with full float32 DFT precision
(``BIAHUB_TPU_FFT_PRECISION=highest``). Tolerance against the reference:
max |port - ref| <= 1e-5 * max |ref|, the engine's own envelope. Against the
port's unsharded route the sharded result is bit-equal: every z slice (A,
C) and every (ky, kx) column (B) is transformed alone.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from biahub_tpu.kernels.deconvolve import compute_transfer_function as jax_tf
from biahub_tpu.parallel import sharded_fft as jsf
from biahub_tpu_torch import deconvolve_arrays, deconvolve_settings_from_reference
from biahub_tpu_torch.estimate_stabilization import ArrayPosition
from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.kernels import deconvolve as tdec
from biahub_tpu_torch.kernels import fft as tfft
from biahub_tpu_torch.parallel import sharded_fft as tsf
from biahub_tpu_torch.parallel.mesh import Mesh, get_mesh

RTOL = 1e-5
REG = 1e-3


def psf3() -> np.ndarray:
    """The reference tests' 3^3 Gaussian PSF (tests/test_sharded_fft.py)."""
    return np.exp(-np.sum(np.square(np.mgrid[-1:2, -1:2, -1:2] / 1.2), axis=0)).astype(
        np.float32)


def tf_half(shape) -> np.ndarray:
    return jax_tf(psf3(), shape)[..., : shape[-1] // 2 + 1]


def jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("space",))


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.fixture
def highest(monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")


@pytest.mark.parametrize("shape,n", [((16, 16, 32), 8), ((12, 8, 16), 4), ((8, 24, 20), 4)],
                         ids=["16x16x32/8", "odd-z_l/4", "y24-x20/4"])
def test_deconvolve_sharded_matches_reference(shape, n, highest):
    vol = np.random.default_rng(13).standard_normal(shape, dtype=np.float32)
    tf = tf_half(shape)
    want = np.asarray(jsf.deconvolve_zyx_sharded(jnp.asarray(vol), jnp.asarray(tf),
                                                 jax_mesh(n), regularization_strength=REG))
    slabs = tsf.deconvolve_zyx_sharded(vol, tf, Mesh.virtual("cpu", n), REG)
    assert [tuple(s.shape) for s in slabs] == [(shape[0] // n,) + shape[1:]] * n
    assert all(s.dtype == torch.float32 for s in slabs)
    close(tsf.gather(slabs, "cpu"), want)


def test_fourier_filter_sharded_matches_reference(highest):
    shape, n = (16, 16, 32), 8
    rng = np.random.default_rng(19)
    vol = rng.standard_normal(shape, dtype=np.float32)
    h = np.fft.fftn(rng.standard_normal(shape).astype(np.float32)).astype(np.complex64)
    filt = tfft.prepare_hermitian_filter(shape, h, 1e-2, "cpu")
    want = np.asarray(jsf.fourier_filter_zyx_sharded(
        jnp.asarray(vol), jnp.asarray(filt.real.numpy()), jnp.asarray(filt.imag.numpy()),
        jax_mesh(n)))
    got = tsf.gather(tsf.fourier_filter_zyx_sharded(vol, filt, Mesh.virtual("cpu", n)), "cpu")
    close(got, want)
    # The same filter sharded once and passed again gives the same slabs.
    sharded = tsf.shard_filter(filt, shape, Mesh.virtual("cpu", n))
    again = tsf.fourier_filter_zyx_sharded(vol, sharded, Mesh.virtual("cpu", n))
    assert torch.equal(tsf.gather(again, "cpu"), got)


@pytest.mark.parametrize("shape,n", [((16, 16, 32), 8), ((12, 8, 16), 4), ((86, 64, 60), 2),
                                     ((64, 64, 128), 4), ((8, 16, 16), 8)],
                         ids=["16x16x32/8", "odd-z_l/4", "86x64x60/2", "64x64x128/4",
                              "one-z-slice/8"])
def test_sharded_is_bit_equal_to_unsharded(shape, n):
    rng = np.random.default_rng(7)
    vol = rng.standard_normal(shape, dtype=np.float32)
    tf = rng.random(tfft.half_spectrum_shape(shape), dtype=np.float32)
    mesh = Mesh.virtual("cpu", n)
    prepared = tsf.prepare_sharded_filter(shape, tf, REG, mesh)
    want = tdec.deconvolve_zyx(vol, tf, REG, device="cpu")
    assert torch.equal(tsf.gather(tsf.deconvolve_zyx_sharded(vol, None, mesh,
                                                             prepared=prepared), "cpu"), want)
    # The per-shard filter is the unsharded one's ky rows, bit for bit.
    full = tfft.prepare_fourier_filter(shape, tf, REG, "cpu")
    assert torch.equal(torch.cat(prepared.shards, dim=1), full)
    assert all(f.is_contiguous() for f in prepared.shards)
    # uint16 goes to the slabs as it is and reads exactly.
    u16 = rng.integers(0, 65536, shape, dtype=np.uint16)
    assert torch.equal(
        tsf.gather(tsf.deconvolve_zyx_sharded(u16, None, mesh, prepared=prepared), "cpu"),
        tsf.gather(tsf.deconvolve_zyx_sharded(u16.astype(np.float32), None, mesh,
                                              prepared=prepared), "cpu"))


def test_exchanges_move_the_spectrum_between_slabs_and_rows():
    shape, n = (8, 12, 6), 4
    spec = torch.randn(shape, dtype=torch.complex64)
    slabs = list(spec.split(shape[0] // n))
    rows = tsf.to_ky_rows(slabs)
    assert all(torch.equal(r, c) for r, c in zip(rows, spec.split(shape[1] // n, dim=1)))
    back = [torch.zeros_like(s) for s in slabs]
    tsf.to_z_slabs(rows, back)
    assert torch.equal(torch.cat(back), spec)


@pytest.mark.parametrize("shape,n", [((10, 16, 16), 8), ((16, 12, 16), 8), ((16, 16, 1), 2)])
def test_undivisible_shapes_raise(shape, n):
    assert not tsf.sharded_fft_supported(shape, n, "cpu")
    mesh = Mesh.virtual("cpu", n)
    vol = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="divisible"):
        tsf.deconvolve_zyx_sharded(vol, np.zeros(tfft.half_spectrum_shape(shape), np.float32),
                                   mesh)
    with pytest.raises(ValueError, match="divisible"):
        tsf.fourier_filter_zyx_sharded(
            vol, torch.zeros(tfft.half_spectrum_shape(shape), dtype=torch.complex64), mesh)


def test_supported_shapes_and_the_kernels_limits():
    assert tsf.sharded_fft_supported((16, 16, 16), 8, "cpu")
    assert not tsf.sharded_fft_supported((86, 1024, 484), 4)
    assert tsf.sharded_fft_supported((86, 1024, 484), 2)
    # X past kernel A's limit shards on the CPU, not on the card.
    assert tsf.sharded_fft_supported((16, 16, 16384), 2, "cpu")
    assert not tsf.sharded_fft_supported((16, 16, 16384), 2, "cuda")


def test_a_filter_for_another_shape_or_mesh_raises():
    shape = (8, 8, 8)
    tf = np.ones(tfft.half_spectrum_shape(shape), np.float32)
    prepared = tsf.prepare_sharded_filter(shape, tf, REG, Mesh.virtual("cpu", 4))
    with pytest.raises(ValueError, match="prepared"):
        tsf.deconvolve_zyx_sharded(np.zeros(shape, np.float32), None, Mesh.virtual("cpu", 2),
                                   prepared=prepared)
    with pytest.raises(ValueError, match="prepared"):
        tsf.deconvolve_zyx_sharded(np.zeros((8, 8, 10), np.float32), None,
                                   Mesh.virtual("cpu", 4), prepared=prepared)


def test_mesh():
    mesh = Mesh.virtual("cpu", 3)
    assert mesh.size == 3 and set(mesh.devices) == {torch.device("cpu")}
    assert get_mesh(device="cpu") == Mesh((torch.device("cpu"),))
    with pytest.raises(ValueError, match="at least one"):
        Mesh.virtual("cpu", 0)
    with pytest.raises(ValueError, match="asked for 2 devices"):
        get_mesh(2, device="cpu")


class FakeLib:
    """Kernel A's and C's C entries: records each launch's shape and writes
    the plain version's result into the wrapper's output."""

    def __init__(self, out, plain):
        self.out, self.plain, self.launches = out, plain, []

    def _launch(self, *args):
        self.launches.append(args[-4:-1])
        self.out.copy_(self.plain())
        return 0

    fwd_yx = inv_yx = _launch


@pytest.mark.parametrize("kernel", ["fwd_yx", "inv_yx"])
def test_kernels_a_and_c_take_one_z_slice(kernel, monkeypatch):
    """A and C launch one block per z slice and transform Y and X only: a
    (1, Y, X) volume passes their gate (Z is B's axis); Y and X still
    need 2 points."""
    vol = torch.rand((1, 16, 24))
    spec = torch.fft.rfftn(torch.rand((1, 16, 24)), dim=(1, 2))
    if kernel == "fwd_yx":
        out = torch.empty_like(spec)
        plain = lambda: tfft.fwd_yx_plain(vol)  # noqa: E731
        call = lambda: tfft.fwd_yx(vol, out=out)  # noqa: E731
    else:
        out = torch.empty_like(vol)
        plain = lambda: tfft.inv_yx_plain(spec.clone(), out=torch.empty_like(vol))  # noqa: E731
        call = lambda: tfft.inv_yx(spec.clone(), out=out)  # noqa: E731
    lib = FakeLib(out, plain)
    monkeypatch.setattr(_build, "on_card", lambda t, what: True)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(tfft, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    _build.reset_launch_counts()
    got = call()
    assert lib.launches == [(1, 16, 24)] and _build.launch_counts == {kernel: 1}
    assert torch.equal(got, plain())
    with pytest.raises(ValueError, match="2 to 8192"):
        tfft._check_slices((1, 1, 24), kernel)
    with pytest.raises(ValueError, match="z slices"):
        tfft._check_slices((0, 16, 24), kernel)


# -- the deconvolve verb on arrays ------------------------------------------


def test_deconvolve_arrays_matches_the_reference_verb(tmp_path, monkeypatch, capsys, highest):
    """The reference's deconvolve verb with BIAHUB_TPU_SHARDED_FFT=1 on a
    1-position, T=2 plate against deconvolve_arrays, sharded over 8 virtual
    CPU shards and batched: the plate within 1e-5 and the transfer function
    bit-equal."""
    import yaml
    from click.testing import CliRunner

    from biahub_tpu.cli.main import cli
    from biahub_tpu.io.ngff import TransformationMeta, open_ome_zarr

    shape, scale = (2, 1, 16, 16, 32), [1.0, 1.0, 1.0, 0.1, 0.1]
    data = np.random.default_rng(29).random(shape).astype(np.float32)
    plate_path = tmp_path / "in.zarr"
    plate = open_ome_zarr(plate_path, layout="hcs", mode="w", channel_names=["a"])
    plate.create_position("A", "1", "0").create_image(
        "0", data, transform=[TransformationMeta(type="scale", scale=scale)])
    psf_path = tmp_path / "psf.zarr"
    psf_store = open_ome_zarr(psf_path, layout="hcs", mode="w", channel_names=["p"])
    psf_store.create_position("0", "0", "0").create_image(
        "0", psf3()[None, None], transform=[TransformationMeta(type="scale", scale=scale)])
    settings = {"regularization_strength": 0.001}
    cfg = tmp_path / "decon.yml"
    cfg.write_text(yaml.dump(settings))
    monkeypatch.setenv("BIAHUB_TPU_SHARDED_FFT", "1")
    out = tmp_path / "out" / "decon.zarr"
    result = CliRunner().invoke(cli, ["deconvolve", "-i", str(plate_path / "A" / "1" / "0"),
                                      "-p", str(psf_path), "-c", str(cfg), "-o", str(out)])
    assert result.exit_code == 0, result.output
    assert "sharded over 8 local devices" in result.output
    want = np.asarray(open_ome_zarr(out / "A" / "1" / "0").data[:])
    want_tf = np.asarray(open_ome_zarr(tmp_path / "out" / "transfer_function.zarr").data[0, 0])

    positions = {"A/1/0": ArrayPosition(data, scale, ["a"])}
    capsys.readouterr()
    sharded, tf = deconvolve_arrays(positions, psf3(), scale, settings,
                                    mesh=Mesh.virtual("cpu", 8), sharded=True, device="cpu")
    assert "sharded over 8 devices" in capsys.readouterr().out
    batched, tf_b = deconvolve_arrays(positions, psf3(), scale, settings, device="cpu")
    np.testing.assert_array_equal(tf, want_tf)
    np.testing.assert_array_equal(tf_b, want_tf)
    assert set(sharded) == {"A/1/0"}
    close(sharded["A/1/0"], want)
    close(batched["A/1/0"], want)
    assert torch.equal(sharded["A/1/0"], batched["A/1/0"])


def test_deconvolve_arrays_routes_and_warnings(capsys):
    shape = (1, 2, 8, 8, 8)
    data = np.random.default_rng(3).integers(0, 4000, shape, dtype=np.uint16)
    positions = {"A/1/0": ArrayPosition(data, [1, 1, 2.0, 0.5, 0.5], ["a", "b"]),
                 "B/1/0": ArrayPosition(data[:, ::-1].copy(), [1, 1, 2.0, 0.5, 0.5],
                                        ["a", "b"])}
    batched, _ = deconvolve_arrays(positions, psf3(), [1, 1, 1.0, 0.5, 0.5], {}, device="cpu")
    assert "Warning: PSF scale: [1.0, 0.5, 0.5] does not match data scale: [2.0, 0.5, 0.5]" \
        in capsys.readouterr().out
    assert torch.equal(batched["B/1/0"][0, 0], batched["A/1/0"][0, 1])
    # A mesh of one shard takes the batched route and says so.
    one, _ = deconvolve_arrays(positions, psf3(), [2.0, 0.5, 0.5], {},
                               mesh=Mesh.virtual("cpu", 1), sharded=True, device="cpu")
    assert "batched route" in capsys.readouterr().err
    assert all(torch.equal(one[k], batched[k]) for k in positions)
    four, _ = deconvolve_arrays(positions, psf3(), [2.0, 0.5, 0.5], {},
                                mesh=Mesh.virtual("cpu", 4), sharded=True, device="cpu")
    assert all(torch.equal(four[k], batched[k]) for k in positions)
    # A shape that does not shard takes the batched route and says so, as
    # the reference's verb does.
    three, _ = deconvolve_arrays(positions, psf3(), [2.0, 0.5, 0.5], {},
                                 mesh=Mesh.virtual("cpu", 3), sharded=True, device="cpu")
    assert "batched route" in capsys.readouterr().err
    assert all(torch.equal(three[k], batched[k]) for k in positions)


def test_deconvolve_settings_from_reference():
    assert deconvolve_settings_from_reference({}) == {
        "regularization_strength": 0.001, "output_ome_zarr_version": None}
    assert deconvolve_settings_from_reference(
        {"regularization_strength": 0.01, "output_ome_zarr_version": "0.5"}
    )["regularization_strength"] == 0.01
    for bad in ({"regularization_strength": 0.0}, {"output_ome_zarr_version": "0.3"},
                {"regularization": 1.0}):
        with pytest.raises(ValueError):
            deconvolve_settings_from_reference(bad)

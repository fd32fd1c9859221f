"""biahub_tpu_torch reconstruction against biahub_tpu on the same inputs.

The port runs its plain PyTorch versions here (CPU tensors): kernels A, Bc
and C become ``torch.fft`` on the rfft half-spectrum. The reference runs its
XLA route (``BIAHUB_TPU_NO_PALLAS=1``, full complex FFTs) or its Pallas
engine in interpret mode (``BIAHUB_TPU_FORCE_PALLAS=1``, radix kernels
engaged from 16, full float32 DFT precision). Tolerances: the golden
fixture's own (5e-6; 5e-6 x scale) for the transfer functions; 1e-5 x
max|ref| per output channel for the reconstructions.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from biahub_tpu.apply_inverse_transfer_function import _make_recon_kernel
from biahub_tpu.recon import birefringence as jbir
from biahub_tpu.recon import optics as joptics
from biahub_tpu.recon.settings import ReconstructionSettings
from biahub_tpu_torch import (
    apply_inverse_transfer_function_arrays,
    compute_transfer_function_arrays,
    output_channel_names,
    reconstruct_arrays,
    reconstruction_settings_from_reference,
    transfer_functions_from_reference,
)
from biahub_tpu_torch.kernels import _build
from biahub_tpu_torch.recon import birefringence as tbir
from biahub_tpu_torch.recon import optics as toptics

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = np.load(ROOT / "tests" / "golden" / "recon_golden.npz")
EXAMPLE = ROOT / "settings" / "example_reconstruct_settings.yml"
# All three modalities on five polarization states; the default swing.
FULL = {
    "input_channel_names": ["State0", "State1", "State2", "State3", "State4"],
    "birefringence": {"transfer_function": {"swing": 0.1}},
    "phase": {"apply_inverse": {"regularization_strength": 1e-3}},
    "fluorescence": {"apply_inverse": {"regularization_strength": 1e-2}},
}
CHANNELS = ["State3", "State0", "State1", "State4", "State2", "GFP"]


@pytest.fixture
def jax_route(request, monkeypatch):
    """Pin the reference's Tikhonov inverse route: 'xla' or 'pallas'."""
    if request.param == "xla":
        monkeypatch.setenv("BIAHUB_TPU_NO_PALLAS", "1")
    else:
        monkeypatch.setenv("BIAHUB_TPU_FORCE_PALLAS", "1")
        monkeypatch.setenv("BIAHUB_TPU_FFT_RADIX_MIN", "16")
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def golden_params():
    zyx = tuple(int(s) for s in GOLDEN["zyx_shape"])
    yx_px, z_px, wave, na_det, na_ill, n_media = (float(v) for v in GOLDEN["params"])
    return zyx, yx_px, z_px, wave, na_det, na_ill, n_media


def assert_close(got: np.ndarray, want: np.ndarray, rtol: float, what: str) -> None:
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), f"{what}: {err:.3g} vs max {np.abs(want).max():.3g}"


def reference_tfs(shape, settings: dict) -> dict:
    """The reference's transfer functions as its store carries them: float32
    real and imaginary parts recombined (compute_transfer_function.py:36-70,
    apply_inverse_transfer_function.py:43-56)."""
    s = ReconstructionSettings(**settings)
    tfs = {}
    if s.phase is not None:
        tf = s.phase.transfer_function
        h = np.asarray(joptics.phase_wotf_3d(
            tuple(shape), tf.yx_pixel_size, tf.z_pixel_size, tf.wavelength_illumination,
            tf.numerical_aperture_illumination, tf.numerical_aperture_detection,
            tf.index_of_refraction_media, tf.invert_phase_contrast))
        tfs["phase"] = h.real.astype(np.float32) + 1j * h.imag.astype(np.float32)
    if s.fluorescence is not None:
        tf = s.fluorescence.transfer_function
        h = np.asarray(joptics.fluorescence_otf_3d(
            tuple(shape), tf.yx_pixel_size, tf.z_pixel_size, tf.wavelength_emission,
            tf.numerical_aperture_detection, tf.index_of_refraction_media))
        tfs["fluorescence"] = h.real.astype(np.float32) + 1j * h.imag.astype(np.float32)
    return tfs


def polarization_stack(shape, t=1, seed=0) -> np.ndarray:
    """(T, 6, Z, Y, X) intensities in CHANNELS' order: five polarization
    states rendered through the default swing's instrument matrix from
    Stokes vectors of random transmittance (100-110), retardance (0.2-1.2
    rad), orientation and degree of polarization (0.8-1), and a GFP
    channel."""
    rng = np.random.default_rng(seed)
    size = (t,) + tuple(shape)
    s0 = 100.0 * (1.0 + 0.1 * rng.random(size))
    ret, theta = rng.uniform(0.2, 1.2, size), rng.uniform(0.0, np.pi, size)
    dop = rng.uniform(0.8, 1.0, size)
    stokes = np.stack([s0, s0 * dop * np.sin(ret) * np.sin(2 * theta),
                       s0 * dop * np.sin(ret) * np.cos(2 * theta), s0 * dop * np.cos(ret)], 1)
    states = np.einsum("sk,tk...->ts...", tbir.instrument_matrix(5, 0.1).astype(np.float64),
                       stokes)
    gfp = 50.0 + 10.0 * rng.random((t, 1) + tuple(shape))
    order = [int(n[-1]) for n in CHANNELS[:5]]
    return np.concatenate([states[:, order], gfp], 1).astype(np.float32)


def reference_reconstruction(tczyx, channels, settings, tfs, times) -> np.ndarray:
    s = ReconstructionSettings(**settings)
    kernel = _make_recon_kernel(s, {k: jnp.asarray(v) for k, v in tfs.items()})
    idx = [channels.index(n) for n in s.input_channel_names]
    return np.stack([np.asarray(kernel(jnp.asarray(tczyx[t][idx]))) for t in times])


# -- optics -------------------------------------------------------------------

def test_numpy_helpers_are_the_references():
    for shape, px in (((8, 8), 0.325), ((9, 17), 0.2)):
        np.testing.assert_array_equal(toptics.pupil(shape, px, 1.2, 0.532),
                                      joptics.pupil(shape, px, 1.2, 0.532))
        np.testing.assert_array_equal(toptics._kz(shape, px, 0.532, 1.3),
                                      joptics._kz(shape, px, 0.532, 1.3))
    np.testing.assert_array_equal(toptics._z_coords(9, 2.0), joptics._z_coords(9, 2.0))
    np.testing.assert_array_equal(tbir.instrument_matrix(4, 0.1), jbir.instrument_matrix(4, 0.1))


def test_fluorescence_otf_matches_golden_and_reference():
    zyx, yx_px, z_px, wave, na_det, _, n_media = golden_params()
    got = toptics.fluorescence_otf_3d(zyx, yx_px, z_px, wave, na_det, n_media, device="cpu")
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), GOLDEN["fluorescence_otf"], atol=5e-6)
    for shape in ((8, 16, 24), (9, 10, 17)):
        want = np.asarray(joptics.fluorescence_otf_3d(shape, 0.325, 2.0, 0.507, 1.2, 1.3))
        got = toptics.fluorescence_otf_3d(shape, 0.325, 2.0, 0.507, 1.2, 1.3, device="cpu")
        assert_close(got.numpy(), want, 5e-6, f"fluorescence OTF {shape}")


def test_phase_wotf_matches_golden_and_reference():
    zyx, yx_px, z_px, wave, na_det, na_ill, n_media = golden_params()
    got = toptics.phase_wotf_3d(zyx, yx_px, z_px, wave, na_ill, na_det, n_media, device="cpu")
    want = GOLDEN["phase_wotf"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6 * np.abs(want).max())
    for shape, invert in (((8, 16, 24), False), ((9, 10, 17), True)):
        want = np.asarray(joptics.phase_wotf_3d(shape, 0.325, 2.0, 0.532, 0.52, 1.2, 1.3, invert))
        got = toptics.phase_wotf_3d(shape, 0.325, 2.0, 0.532, 0.52, 1.2, 1.3, invert,
                                    device="cpu")
        assert_close(got.numpy(), want, 5e-6, f"phase WOTF {shape}")


@pytest.mark.parametrize("jax_route", ["xla", "pallas"], indirect=True)
def test_tikhonov_inverse_hermitian_matches_reference(jax_route):
    shape = (8, 16, 24)
    vol = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    h = reference_tfs(shape, {"phase": {}})["phase"]
    want = np.asarray(joptics.tikhonov_inverse_3d(jnp.asarray(vol), jnp.asarray(h), 1e-3,
                                                  assume_hermitian=True))
    _build.reset_launch_counts()
    got = toptics.tikhonov_inverse_3d(vol, h, 1e-3, device="cpu")
    assert _build.launch_counts == {}
    assert_close(got.numpy(), want, RTOL, jax_route)


# -- birefringence -------------------------------------------------------------

def test_birefringence_recovers_golden_forward_model():
    swing = float(GOLDEN["biref_swing"])
    stokes = tbir.stokes_from_intensities(
        torch.from_numpy(GOLDEN["biref_intensities"].astype(np.float32)), swing)
    out = tbir.birefringence_from_stokes(stokes, 0.532).numpy()
    np.testing.assert_allclose(out[0] * 2 * np.pi / 0.532, GOLDEN["biref_retardance_rad"],
                               atol=1e-3)
    dtheta = np.abs(out[1] - GOLDEN["biref_orientation"]) % np.pi
    assert np.minimum(dtheta, np.pi - dtheta).max() < 1e-3
    np.testing.assert_allclose(out[2], GOLDEN["biref_transmittance"], atol=1e-3)
    np.testing.assert_allclose(out[3], GOLDEN["biref_dop"], atol=1e-3)


# The golden fixture's swing, 0.03, makes the instrument matrix's
# pseudo-inverse entries ~55 that cancel to S0 and S3 of order 1: the two
# float32 pseudo-inverses (torch's and JAX's SVD) are 1e-5 to 2e-5 of
# max|S| from the float64 one there, so the Stokes vectors are held at 5e-5;
# at the settings' default swing, 0.1, at 1e-5.
@pytest.mark.parametrize("swing,rtol", [(0.03, 5e-5), (0.1, RTOL)])
@pytest.mark.parametrize("n_states", [4, 5])
def test_stokes_and_birefringence_match_reference(n_states, swing, rtol):
    czyx = (1.0 + np.random.default_rng(n_states).random((n_states, 3, 5, 7))).astype(np.float32)
    want = np.asarray(jbir.stokes_from_intensities(jnp.asarray(czyx), swing))
    got = tbir.stokes_from_intensities(torch.from_numpy(czyx), swing)
    assert_close(got.numpy(), want, rtol, "Stokes")
    for flip, rotate in ((False, False), (True, True)):
        want_b = np.asarray(jbir.birefringence_from_stokes(jnp.asarray(got.numpy()), 0.532,
                                                           flip, rotate))
        got_b = tbir.birefringence_from_stokes(got, 0.532, flip, rotate).numpy()
        for c in range(4):
            assert_close(got_b[c], want_b[c], RTOL, f"birefringence channel {c}")


# -- settings ------------------------------------------------------------------

def load_example() -> dict:
    with open(EXAMPLE) as f:
        return yaml.safe_load(f)


ACCEPTED = [
    {},
    {"reconstruction_dimension": 2, "time_indices": [0, "1"], "phase": {}},
    {"time_indices": "3", "input_channel_names": ("a", "b"), "fluorescence": None},
    {"birefringence": {"transfer_function": {"swing": "0.2"},
                       "apply_inverse": {"flip_orientation": "yes"}}},
    {"phase": {"transfer_function": {"z_padding": 2.0, "invert_phase_contrast": 1},
               "apply_inverse": {"reconstruction_algorithm": "TV", "TV_iterations": 3}}},
    {"fluorescence": {"transfer_function": {"wavelength_emission": 0.6}},
     "reconstruction_dimension": 3.0, "time_indices": 2},
]
REFUSED = [
    {"bogus": 1},
    {"fluorescence": {"bogus": 1}},
    {"phase": {"transfer_function": {"bogus": 1}}},
    {"reconstruction_dimension": 4},
    {"reconstruction_dimension": "3"},
    {"time_indices": "some"},
    {"input_channel_names": ["a", 1]},
    {"phase": {"transfer_function": {"z_padding": -1}}},
    {"phase": {"transfer_function": {"z_padding": 1.5}}},
    {"phase": {"transfer_function": {"yx_pixel_size": 0}}},
    {"phase": {"apply_inverse": {"regularization_strength": -1e-3}}},
    {"phase": {"apply_inverse": {"reconstruction_algorithm": "tv"}}},
    {"birefringence": {"apply_inverse": {"background_path": 3}}},
]


@pytest.mark.parametrize("settings", [None] + ACCEPTED, ids=lambda s: str(s)[:40])
def test_settings_reader_matches_reference(settings):
    settings = load_example() if settings is None else settings
    want = ReconstructionSettings(**settings)
    got = reconstruction_settings_from_reference(settings)
    assert got == want.model_dump()
    assert reconstruction_settings_from_reference(got) == got
    assert output_channel_names(settings) == want.output_channel_names()


@pytest.mark.parametrize("settings", REFUSED, ids=lambda s: str(s)[:40])
def test_settings_reader_refuses_what_the_reference_refuses(settings):
    with pytest.raises(Exception):
        ReconstructionSettings(**settings)
    with pytest.raises(ValueError):
        reconstruction_settings_from_reference(settings)


# -- compute-tf, apply-inv-tf, reconstruct ----------------------------------------

def test_compute_transfer_function_arrays_matches_reference():
    shape = (9, 10, 17)
    settings = dict(FULL, phase={"transfer_function": {"invert_phase_contrast": True}})
    got = compute_transfer_function_arrays(shape, settings, device="cpu")
    want = reference_tfs(shape, settings)
    assert set(got) == set(want) == {"phase", "fluorescence"}
    for name in got:
        assert got[name].dtype == torch.complex64 and tuple(got[name].shape) == shape
        assert_close(got[name].numpy(), want[name], 5e-6, name)
    assert compute_transfer_function_arrays(shape, {"birefringence": {}}, device="cpu") == {}


@pytest.mark.parametrize(
    "jax_route,shape",
    [("xla", (8, 16, 24)), ("xla", (9, 10, 17)), ("pallas", (8, 16, 24))],
    indirect=["jax_route"],
)
def test_apply_inverse_matches_reference(jax_route, shape):
    tczyx = polarization_stack(shape)
    tfs = reference_tfs(shape, FULL)
    want = reference_reconstruction(tczyx, CHANNELS, FULL, tfs, [0])
    got = apply_inverse_transfer_function_arrays(
        tczyx, CHANNELS, transfer_functions_from_reference(tfs), FULL, device="cpu").numpy()
    assert got.shape == want.shape == (1, 10) + shape and got.dtype == np.float32
    for c, name in enumerate(output_channel_names(FULL)):
        assert_close(got[0, c], want[0, c], RTOL, f"{jax_route} {name}")


def test_reconstruct_arrays_end_to_end():
    shape = (8, 16, 24)
    settings = dict(load_example(), input_channel_names=["State0"], time_indices=[2, 0])
    tczyx = polarization_stack(shape, t=3, seed=1)
    got = reconstruct_arrays(tczyx, CHANNELS, settings, device="cpu").numpy()
    want = reference_reconstruction(tczyx, CHANNELS, settings,
                                    reference_tfs(shape, settings), [2, 0])
    assert got.shape == want.shape == (2, 1) + shape
    assert_close(got, want, RTOL, "Phase3D")
    raw = np.round(tczyx).astype(np.uint16)
    assert torch.equal(reconstruct_arrays(raw, CHANNELS, settings, device="cpu"),
                       reconstruct_arrays(raw.astype(np.float32), CHANNELS, settings,
                                          device="cpu"))


@pytest.mark.parametrize("modality,match", [("phase", "no phase transfer function"),
                                            ("fluorescence", "no fluorescence OTF")])
def test_missing_transfer_function_is_refused(modality, match):
    tczyx = polarization_stack((4, 6, 8))
    tfs = compute_transfer_function_arrays((4, 6, 8), FULL, device="cpu")
    del tfs[modality]
    with pytest.raises(ValueError, match=match):
        apply_inverse_transfer_function_arrays(tczyx, CHANNELS, tfs, FULL, device="cpu")


def test_transfer_functions_from_reference_refuses_unknown_and_flat():
    with pytest.raises(ValueError, match="unknown fields"):
        transfer_functions_from_reference({"identity": np.ones((2, 2, 2))})
    with pytest.raises(ValueError, match="want a"):
        transfer_functions_from_reference({"phase": np.ones((2, 2), np.complex64)})

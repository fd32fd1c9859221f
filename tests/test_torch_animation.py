"""The port's ``visualize/animation_utils.py`` against biahub_tpu's.

``render_frame`` (the composite in torch, bars and text drawn by PIL),
``get_contours``, ``suggest_contrast_limits`` and a GIF ``record_position``
equal the reference's frame for frame, in uint8: the composite repeats the
reference's float32 operations in its order. ``render_frame`` takes
tensors too; the napari wrappers raise the reference's message.
"""

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from biahub_tpu.visualize import animation_utils as J
from biahub_tpu_torch.visualize import animation_utils as T

RNG = np.random.default_rng(0)
CHANNELS = [(RNG.random((40, 60)) * 1000).astype(np.float32) for _ in range(6)]


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", [
    {},
    {"contrast_limits": [(100.0, 900.0)] * 6, "colors": ("red", (0.2, 0.4, 1.0))},
    {"pixel_size_um": 0.5, "scale_bar_um": 5.0, "text": "t = 0h05m, z = 1.00µm"},
    {"pixel_size_um": 0.25, "scale_bar_um": 3.0, "text": "x",
     "scale_bar_position": "TOP_LEFT", "text_position": "BOTTOM_RIGHT",
     "overlay_color": "yellow", "line_width": 2},
], ids=["plain", "limits", "overlays", "corners"])
@pytest.mark.parametrize("n", [1, 3, 6])
def test_render_frame_equals_the_reference(case, n, one_thread):
    def kwargs(mod):
        out = dict(case)
        for key in ("scale_bar_position", "text_position"):
            if key in out:
                out[key] = getattr(mod.ElementPosition, out[key])
        return out

    want = J.render_frame(CHANNELS[:n], **kwargs(J))
    got = T.render_frame(CHANNELS[:n], **kwargs(T), device="cpu")
    assert got.dtype == np.uint8 and got.shape == (40, 60, 3)
    np.testing.assert_array_equal(got, want)
    tensors = [torch.from_numpy(c) for c in CHANNELS[:n]]
    np.testing.assert_array_equal(T.render_frame(tensors, **kwargs(T), device="cpu"), want)


def test_composite_is_a_tensor_on_the_device():
    frame = T.composite_channels(CHANNELS[:2], device="cpu")
    assert frame.dtype == torch.uint8 and tuple(frame.shape) == (40, 60, 3)
    np.testing.assert_array_equal(frame.numpy(), J.render_frame(CHANNELS[:2]))


@pytest.mark.parametrize("thickness", [1, 2])
def test_contours_and_contrast_limits_equal_the_reference(thickness):
    labels = np.kron(RNG.integers(0, 5, (6, 8)), np.ones((5, 5), int))
    np.testing.assert_array_equal(T.get_contours(labels, thickness),
                                  J.get_contours(labels, thickness))
    np.testing.assert_array_equal(T.get_contours(labels[None].repeat(3, 0), thickness, 0),
                                  J.get_contours(labels[None].repeat(3, 0), thickness, 0))
    data = RNG.normal(100, 20, (3, 4, 30, 20)).astype(np.float32)
    assert T.suggest_contrast_limits(data) == J.suggest_contrast_limits(data)
    assert T.suggest_contrast_limits(torch.from_numpy(data)) == J.suggest_contrast_limits(data)


def gif_frames(path):
    return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(path))]


def test_record_position_gif_equals_the_reference(tmp_path, one_thread):
    data = (RNG.random((4, 2, 6, 24, 32)) * 200).astype(np.float32)
    kw = dict(channels=[0, 1], loop_axes=[(0, (None, None), 0.4), (1, (1, 4), 0.3)], fps=10,
              scale=[2.0, 1.0, 0.5, 0.2, 0.2], pixel_size_um=0.2, scale_bar_um=1.0)
    want = J.record_position(data, tmp_path / "ref" / "movie.gif", **kw)
    got = T.record_position(data, tmp_path / "port" / "movie.gif", device="cpu", **kw)
    frames, ref_frames = gif_frames(got), gif_frames(want)
    # PIL merges repeated frames (the buffer holds) into one of longer duration.
    assert len(frames) == len(ref_frames) >= 4
    assert got.read_bytes() == want.read_bytes()
    for a, b in zip(frames, ref_frames):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="loopable axes"):
        T.record_position(data, tmp_path / "x.gif", loop_axes=[(2, (None, None), 1)],
                          device="cpu")
    with pytest.raises(ValueError, match="expects"):
        T.record_position(data[0], tmp_path / "x.gif", device="cpu")


def test_napari_wrappers_raise_the_reference_message():
    for call in (lambda m: m.add_scale_bar(None, 0.2), lambda m: m.add_text_overlay(None, "t"),
                 lambda m: m.simple_recording(None, "x.mp4", 3)):
        with pytest.raises(RuntimeError) as want:
            call(J)
        with pytest.raises(RuntimeError) as got:
            call(T)
        assert str(got.value) == str(want.value) and "napari" in str(got.value)

"""Frame rendering, movie recording and visualization math, headless.

Counterpart of ``biahub_tpu/visualize/animation_utils.py``: multi-channel
composite frames (:func:`composite_channels`, on the device in torch),
scale bars and time/z text drawn on them with PIL (:func:`render_frame`),
and axis-loop recordings with buffer holds (:func:`record_position`),
written as GIF through PIL or as MP4 through an ``ffmpeg`` binary. Where PIL
is not installed :func:`render_frame` raises its ``ImportError``, as the
reference does. The napari wrappers raise the reference's message where
napari is not installed.
"""

from __future__ import annotations

import itertools
import shutil
import subprocess
import threading
from enum import Enum
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = [
    "ElementPosition",
    "get_contours",
    "suggest_contrast_limits",
    "composite_channels",
    "render_frame",
    "record_position",
    "add_scale_bar",
    "add_text_overlay",
    "simple_recording",
]

# Matplotlib's CSS color table without importing matplotlib at module load.
_COLORS = {
    "white": (255, 255, 255),
    "gray": (128, 128, 128),
    "red": (255, 0, 0),
    "green": (0, 255, 0),
    "blue": (0, 0, 255),
    "magenta": (255, 0, 255),
    "cyan": (0, 255, 255),
    "yellow": (255, 255, 0),
    "orange": (255, 165, 0),
}


class ElementPosition(Enum):
    TOP_LEFT = "top_left"
    TOP_RIGHT = "top_right"
    BOTTOM_LEFT = "bottom_left"
    BOTTOM_RIGHT = "bottom_right"


def get_contours(labels: np.ndarray, thickness: int = 1, background_label: int = 0):
    """Contour mask of a label image: labeled pixels whose eroded interior
    differs (grey erosion by a full box, ``thickness`` times)."""
    from scipy import ndimage

    labels = np.asarray(labels)
    structure = np.ones((3,) * labels.ndim, dtype=bool)
    eroded = labels.copy()
    for _ in range(thickness):
        eroded = ndimage.grey_erosion(eroded, footprint=structure)
    contours = np.where(labels != eroded, labels, background_label)
    contours[labels == background_label] = background_label
    return contours


def suggest_contrast_limits(intensity_array: np.ndarray) -> tuple[float, float]:
    """Robust display range: the 1st and 99.9th percentiles (numpy or a
    tensor, on the host)."""
    if isinstance(intensity_array, torch.Tensor):
        intensity_array = intensity_array.cpu().numpy()
    data = np.asarray(intensity_array).ravel()
    low, high = np.percentile(data, [1.0, 99.9])
    return float(low), float(high)


# ---------------------------------------------------------------------------
# Headless rendering
# ---------------------------------------------------------------------------


def _color_rgb(color) -> tuple[int, int, int]:
    if isinstance(color, (tuple, list)):
        arr = np.asarray(color, dtype=np.float64)
        if arr.max() <= 1.0:
            arr = arr * 255
        return tuple(int(c) for c in arr[:3])
    return _COLORS.get(str(color).lower(), (255, 255, 255))


def _anchor_xy(position: ElementPosition, size, margin_factor: float):
    """(x, y) anchor of an element box for a (H, W) canvas, ``margin_factor``
    of each side from its corner."""
    h, w = size
    mx, my = int(w * margin_factor), int(h * margin_factor)
    return {
        ElementPosition.TOP_LEFT: (mx, my, "lt"),
        ElementPosition.TOP_RIGHT: (w - mx, my, "rt"),
        ElementPosition.BOTTOM_LEFT: (mx, h - my, "lb"),
        ElementPosition.BOTTOM_RIGHT: (w - mx, h - my, "rb"),
    }[position]


def composite_channels(channels, contrast_limits=None,
                       colors=("gray", "green", "magenta", "cyan", "yellow"),
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """(H, W, 3) uint8 tensor on ``device``: the (Y, X) channel images (numpy
    or tensors), each scaled to its contrast limits (default
    :func:`suggest_contrast_limits`), clipped to [0, 1] and added in its
    color; colors cycle past the palette's end."""
    dev = resolve_device(device)
    if contrast_limits is None:
        contrast_limits = [suggest_contrast_limits(c) for c in channels]
    images = [as_tensor(c, dev) for c in channels]
    # Per channel: lo, the span, and the color scaled to [0, 1] (in float32
    # on the host, as numpy scales it), copied to the device at once. The
    # span is a device tensor: divided by a Python number, the card would
    # multiply by its reciprocal.
    table = np.array([[lo, max(hi - lo, 1e-12), *(np.asarray(_color_rgb(color), np.float32)
                                                  / np.float32(255.0))]
                      for (lo, hi), color in zip(contrast_limits, itertools.cycle(colors))],
                     dtype=np.float32)
    table = torch.from_numpy(table).to(dev)
    rgb = torch.zeros(tuple(images[0].shape) + (3,), dtype=torch.float32, device=dev)
    for img, row in zip(images, table):
        norm = torch.clamp((img - row[0]) / row[1], 0.0, 1.0)
        rgb += norm[..., None] * row[2:]
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_frame(
    channels,
    contrast_limits=None,
    colors=("gray", "green", "magenta", "cyan", "yellow"),
    pixel_size_um: float | None = None,
    scale_bar_um: float | None = None,
    scale_bar_position: ElementPosition = ElementPosition.BOTTOM_RIGHT,
    line_width: int = 5,
    text: str | None = None,
    text_position: ElementPosition = ElementPosition.TOP_LEFT,
    text_size: int = 20,
    margin_factor: float = 0.05,
    overlay_color="white",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Composite a list of (Y, X) channel images into an (H, W, 3) uint8
    frame with additive color blending (:func:`composite_channels`, on
    ``device``), then draw an optional scale bar and an optional text
    overlay with PIL on the host."""
    from PIL import Image, ImageDraw

    shape = tuple(channels[0].shape)
    frame = composite_channels(channels, contrast_limits, colors, device).cpu().numpy()

    image = Image.fromarray(frame)
    draw = ImageDraw.Draw(image)
    ocolor = _color_rgb(overlay_color)

    if scale_bar_um is not None:
        if pixel_size_um is None:
            raise ValueError("scale_bar_um requires pixel_size_um")
        bar_px = max(1, int(round(scale_bar_um / pixel_size_um)))
        x, y, corner = _anchor_xy(scale_bar_position, shape, margin_factor)
        x0 = x - bar_px if corner[0] == "r" else x
        y0 = y - line_width if corner[1] == "b" else y
        draw.rectangle([x0, y0, x0 + bar_px, y0 + line_width], fill=ocolor)
        label = f"{scale_bar_um:g}µm"
        ty = y0 - text_size - 2 if corner[1] == "b" else y0 + line_width + 2
        draw.text((x0 + bar_px // 2, ty), label, fill=ocolor, anchor="ma")

    if text:
        x, y, corner = _anchor_xy(text_position, shape, margin_factor)
        anchor = {"lt": "la", "rt": "ra", "lb": "ld", "rb": "rd"}[corner]
        draw.text((x, y), text, fill=ocolor, anchor=anchor)

    return np.asarray(image)


def _format_overlay_text(
    current_step, scale, time_axis: int | None, z_axis: int | None
) -> str:
    """'t = HhMMm, z = Z.ZZµm', the axis scales in minutes and micrometers."""
    parts = []
    if time_axis is not None:
        total_minutes = current_step[time_axis] * scale[time_axis]
        hh, mm = int(total_minutes // 60), int(total_minutes % 60)
        parts.append(f"t = {hh}h{mm:02d}m")
    if z_axis is not None:
        zz = current_step[z_axis] * scale[z_axis]
        parts.append(f"z = {zz:.2f}µm")
    return ", ".join(parts)


def record_position(
    data,
    output_path,
    loop_axes=None,
    channels: int | list[int] = 0,
    z_focal_plane: int | None = None,
    scale=None,
    contrast_limits=None,
    colors=("gray", "green", "magenta", "cyan", "yellow"),
    pixel_size_um: float | None = None,
    scale_bar_um: float | None = None,
    show_overlay_text: bool = True,
    fps: int = 10,
    buffer_duration: float = 0.5,
    default_duration: float = 5.0,
    device: str | torch.device = "cuda",
) -> Path:
    """Record an axis-loop movie from a (T, C, Z, Y, X) array headlessly,
    each frame composited on ``device``.

    The headless analog of ``simple_recording``: ``loop_axes``
    is a list of ``(axis, (min, max), duration_seconds)`` with None meaning
    full range / default duration; each transition holds the final frame for
    ``buffer_duration`` seconds. Axis 0 is time, axis 1 (of the ZYX stack)
    is z. Writes a GIF everywhere; '.mp4' requires an ffmpeg binary.
    """
    data = np.asarray(data)
    if data.ndim != 5:
        raise ValueError("record_position expects (T, C, Z, Y, X) data")
    output_path = Path(output_path)
    if loop_axes is None:
        loop_axes = [(0, (None, None), None)]
    channel_list = [channels] if isinstance(channels, int) else list(channels)
    scale = list(scale) if scale is not None else [1.0] * 5
    T, C, Z, Y, X = data.shape
    axis_sizes = {0: T, 1: Z}

    if contrast_limits is None:
        contrast_limits = [
            suggest_contrast_limits(data[:, c]) for c in channel_list
        ]

    state = {0: 0, 1: Z // 2 if z_focal_plane is None else int(z_focal_plane)}
    frames = []
    buffer_frames = int(buffer_duration * fps)

    def snap():
        t, z = state[0], state[1]
        text = None
        if show_overlay_text:
            text = _format_overlay_text((t, z), (scale[0], scale[2]), 0, 1)
        frames.append(
            render_frame(
                [data[t, c, z] for c in channel_list],
                contrast_limits=contrast_limits,
                colors=colors,
                pixel_size_um=pixel_size_um,
                scale_bar_um=scale_bar_um,
                text=text,
                device=device,
            )
        )

    for axis, (min_val, max_val), duration in loop_axes:
        if axis not in axis_sizes:
            raise ValueError(f"loopable axes are 0 (time) and 1 (z); got {axis}")
        lo = 0 if min_val is None else int(min_val)
        hi = (axis_sizes[axis] - 1) if max_val is None else int(max_val)
        seconds = default_duration if duration is None else float(duration)
        n_frames = max(2, int(seconds * fps))
        for pos in np.linspace(lo, hi, n_frames).astype(int):
            state[axis] = int(pos)
            snap()
        frames.extend([frames[-1]] * buffer_frames)

    _write_movie(frames, output_path, fps)
    return output_path


def _write_movie(frames, output_path: Path, fps: int) -> None:
    from PIL import Image

    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_path.suffix.lower() == ".gif":
        images = [Image.fromarray(f) for f in frames]
        images[0].save(
            output_path,
            save_all=True,
            append_images=images[1:],
            duration=max(1, int(1000 / fps)),
            loop=0,
        )
        return
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"writing {output_path.suffix} requires an ffmpeg binary; "
            "use a .gif output path in ffmpeg-less environments."
        )
    h, w = frames[0].shape[:2]
    proc = subprocess.Popen(
        [
            ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
            "-pix_fmt", "yuv420p", "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
            str(output_path),
        ],
        stdin=subprocess.PIPE,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )
    # Drain stderr concurrently: ffmpeg's progress chatter can fill the pipe
    # buffer and deadlock the frame-feed loop otherwise.
    stderr_chunks: list[bytes] = []
    drainer = threading.Thread(
        target=lambda: stderr_chunks.append(proc.stderr.read()), daemon=True
    )
    drainer.start()
    try:
        for frame in frames:
            proc.stdin.write(np.ascontiguousarray(frame).tobytes())
        proc.stdin.close()
    except BrokenPipeError:
        pass  # ffmpeg died early; surface its stderr below
    rc = proc.wait()
    drainer.join(timeout=10)
    if rc != 0:
        stderr = b"".join(stderr_chunks).decode(errors="replace")
        raise RuntimeError(
            f"ffmpeg failed writing {output_path}: ...{stderr[-500:]}"
        )


# ---------------------------------------------------------------------------
# napari wrappers (interactive parity; lazy import)
# ---------------------------------------------------------------------------


def _require_napari():
    try:
        import napari  # type: ignore

        return napari
    except ImportError:
        raise RuntimeError(
            "napari is required for interactive overlays/recordings and is not "
            "installed in this headless build; use render_frame/record_position "
            "for headless output."
        ) from None


def add_scale_bar(viewer, pixel_size_um: float, position=ElementPosition.BOTTOM_RIGHT):
    """Enable napari's scale bar in micrometers."""
    _require_napari()
    viewer.scale_bar.visible = True
    viewer.scale_bar.unit = "um"
    return viewer


def add_text_overlay(viewer, text: str, position=ElementPosition.TOP_LEFT):
    """Add a text overlay that tracks the current timepoint."""
    _require_napari()
    viewer.text_overlay.visible = True
    viewer.text_overlay.text = text
    return viewer


def simple_recording(viewer, output_path, n_frames: int, fps: int = 10):
    """Record a dims sweep to a movie (requires napari-animation)."""
    _require_napari()
    try:
        from napari_animation import Animation  # type: ignore
    except ImportError:
        raise RuntimeError("napari-animation is required for movie recording.") from None
    animation = Animation(viewer)
    for t in range(n_frames):
        viewer.dims.set_point(0, t)
        animation.capture_keyframe()
    animation.animate(output_path, fps=fps)

"""crop-background: crop the background of videos with ffmpeg.

Counterpart of ``biahub_tpu/visualize/crop_background.py``: ffmpeg's
``cropdetect`` finds each ``*.mp4``'s content box and a second ffmpeg run
writes the cropped video. Where ffmpeg is absent,
:func:`detect_crop_params` returns None and the video is skipped with a
line, as in the reference.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

__all__ = ["detect_crop_params", "process_video", "crop_background"]


def detect_crop_params(file_path) -> str | None:
    """The content box (``w:h:x:y``) of ffmpeg's cropdetect filter, or None."""
    cmd = ["ffmpeg", "-i", str(file_path), "-vf", "cropdetect", "-frames:v", "64",
           "-f", "null", "-"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    matches = re.findall(r"crop=(\S+)", out.stderr)
    return matches[-1] if matches else None


def process_video(file_path, output_dir) -> Path | None:
    """Crop one video to its detected content box."""
    crop = detect_crop_params(file_path)
    if crop is None:
        print(f"No crop detected for {file_path}")
        return None
    output_path = Path(output_dir) / Path(file_path).name
    subprocess.run(["ffmpeg", "-y", "-i", str(file_path), "-vf", f"crop={crop}",
                    str(output_path)], capture_output=True, check=True)
    return output_path


def crop_background(input_dir, output_dir) -> None:
    """Every ``*.mp4`` of ``input_dir``, in name order, into ``output_dir``."""
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    for file_path in sorted(Path(input_dir).glob("*.mp4")):
        print(f"Processing {file_path}")
        process_video(file_path, output_dir)

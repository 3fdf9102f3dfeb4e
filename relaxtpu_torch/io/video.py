"""Frame sampling and raw-I420 ingest (counterpart of ``relaxtpu/io/video.py``).

Sampling follows the reference's two ffmpeg selects: sampled frames
``not(mod(n, interval))`` and successor frames ``not(mod(n-1, interval))``,
with ``interval = ceil(fps/2) if fps < 2 else int(fps/2)``.

This slice reads raw ``.yuv`` (I420) files with numpy alone.  Container
files (mp4 and the like) need libav or cv2 and wait for a later slice.
"""

from __future__ import annotations

import math
import os

import numpy as np


def frame_interval_for(framerate: float) -> int:
    if framerate < 2:
        return math.ceil(framerate / 2)
    return int(framerate / 2)


def sample_indices(n_frames: int, interval: int) -> list[int]:
    """Frame indices matching ``not(mod(n, interval))``."""
    interval = max(int(interval), 1)
    return list(range(0, n_frames, interval))


def residual_pair_indices(n_frames: int, interval: int) -> list[tuple[int, int]]:
    """(frame, successor) index pairs; a trailing sampled frame with no
    successor is dropped (the reference zips the two PNG lists)."""
    interval = max(int(interval), 1)
    return [(f, f + 1) for f in sample_indices(n_frames, interval) if f + 1 < n_frames]


def read_i420_frames(path: str, width: int, height: int, indices) -> np.ndarray:
    """Packed I420 frames at ``indices`` -> (n, H*W*3/2) uint8 (per frame:
    luma, then U, then V — the layout ``ops.colorspace.unpack_i420`` reads)."""
    frame_bytes = width * height * 3 // 2
    data = np.memmap(path, np.uint8, mode="r")
    n = data.size // frame_bytes
    if any(i >= n for i in indices):
        raise ValueError(f"{path}: frame index beyond the {n} frames in the file")
    frames = data[: n * frame_bytes].reshape(n, frame_bytes)
    return np.ascontiguousarray(frames[np.asarray(indices, np.int64)])


def decode_video_inputs_i420(
    path: str,
    framerate: float | None,
    width: int | None,
    height: int | None,
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(frames_i420, next_i420, h, w) from a raw ``.yuv`` file.

    Counterpart of ``relaxtpu/io/video.py:275`` for raw I420 input: the
    pairs' first frames are the sampled frames, so two stacks carry
    everything.  Raw files carry no metadata, so the frame rate and the
    geometry are required.
    """
    if not path.endswith(".yuv"):
        raise NotImplementedError(
            "container decode (mp4 and the like) is not ported yet; "
            "pass a raw I420 .yuv file"
        )
    if framerate is None or width is None or height is None:
        raise ValueError("a raw .yuv file needs --framerate, --width and --height")
    if width % 2 or height % 2:
        raise ValueError(f"I420 needs even dimensions, got {width}x{height}")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    n = os.path.getsize(path) // (width * height * 3 // 2)
    interval = frame_interval_for(framerate)
    firsts = sample_indices(n, interval)
    pairs = residual_pair_indices(n, interval)
    fbuf = read_i420_frames(path, width, height, firsts)
    nbuf = read_i420_frames(path, width, height, [b for _, b in pairs])
    return fbuf, nbuf, height, width


def _chroma_upsample2x(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.float32)
    return np.repeat(np.repeat(c, 2, axis=-2), 2, axis=-1)


def _yuv420_to_bgr_limited(yuv: np.ndarray, width: int, height: int) -> np.ndarray:
    """Host BT.601 limited-range I420 -> BGR uint8 (own copy of
    ``relaxtpu/io/video.py:108-123``).  Kept as the oracle that the device
    converter ``ops.colorspace.yuv420_to_bgr`` is tested against."""
    y = yuv[:height].astype(np.float32)
    u = yuv[height : height + height // 4].reshape(height // 2, width // 2)
    v = yuv[height + height // 4 :].reshape(height // 2, width // 2)
    u = _chroma_upsample2x(u) - 128.0
    v = _chroma_upsample2x(v) - 128.0
    yl = 1.164383 * (y - 16.0)
    b = yl + 2.017232 * u
    g = yl - 0.812968 * v - 0.391762 * u
    r = yl + 1.596027 * v
    return np.clip(np.rint(np.stack([b, g, r], axis=-1)), 0, 255).astype(np.uint8)

"""Frame decoding and sampling (counterpart of ``relaxtpu/io/video.py``).

Sampling follows the reference's two ffmpeg selects: sampled frames
``not(mod(n, interval))`` and successor frames ``not(mod(n-1, interval))``,
with ``interval = ceil(fps/2) if fps < 2 else int(fps/2)``.

Containers (mp4, mkv, avi, webm) decode through the native libav decoder
(``io/native.py``) when it loads, else through cv2, else raise
:class:`DecoderUnavailable`; neither is imported or loaded until a
container is read.  Raw ``.yuv`` (I420) files give the JAX package's
frames: its ``.yuv`` decode is BGR in every ingest mode, from the native
rawvideo decoder (swscale) where that loads and from the numpy converter
``_yuv420_to_bgr_limited`` where it does not.  :func:`decode_video` picks
the route and says which program takes the result.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np

from relaxtpu_torch.io import native

log = logging.getLogger("relaxtpu_torch.io.video")


class DecoderUnavailable(RuntimeError):
    """Neither the native decoder nor cv2 can read containers on this host."""


class I420Unavailable(ValueError):
    """The decoder cannot give this file as packed I420 (no native decoder,
    odd dimensions, another pixel format, or the metadata's geometry is not
    the stream's); the BGR decode can."""


def _clean_meta(v):
    """None for an absent metadata value: None, NaN, or an empty or "nan"
    string (a CSV cell)."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, str) and v.strip().lower() in ("", "nan"):
        return None
    return v


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


# ------------------------------------------------------------------ raw .yuv
def _yuv420_frame_count(path: str, width: int, height: int) -> int:
    return os.path.getsize(path) // (width * height * 3 // 2)


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


def _chroma_upsample2x(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.float32)
    return np.repeat(np.repeat(c, 2, axis=-2), 2, axis=-1)


def _yuv420_to_bgr_limited(yuv: np.ndarray, width: int, height: int) -> np.ndarray:
    """Host BT.601 limited-range I420 -> BGR uint8 (own copy of
    ``relaxtpu/io/video.py:108-123``); the device converter
    ``ops.colorspace.yuv420_to_bgr`` bit-matches it."""
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


def _read_yuv420_frames(path: str, width: int, height: int, indices: list[int]) -> list[np.ndarray]:
    """Raw ``.yuv`` frames at ``indices`` as BGR uint8: the native rawvideo
    decoder when it loads and gives every frame, else the numpy converter
    (the JAX package's order)."""
    if native.available():
        try:
            with native.NativeDecoder(path, raw={"width": width, "height": height, "pixfmt": "yuv420p"}) as dec:
                frames = list(dec.decode_selected(indices))
            if len(frames) == len(indices):
                return frames
        except ValueError as e:  # a pixel format swscale cannot convert
            log.info("native rawvideo decode of %s failed (%s); numpy converter", path, e)
    frame_bytes = width * height * 3 // 2
    out = []
    with open(path, "rb") as f:
        for idx in indices:
            f.seek(idx * frame_bytes)
            raw = np.frombuffer(f.read(frame_bytes), np.uint8)
            if raw.size < frame_bytes:
                break
            out.append(_yuv420_to_bgr_limited(raw.reshape(height * 3 // 2, width), width, height))
    return out


# ---------------------------------------------------------------- containers
def _cv2(path: str):
    """cv2, or DecoderUnavailable naming both decoders."""
    try:
        import cv2
    except ImportError as e:
        raise DecoderUnavailable(
            f"cannot decode {path}: the native decoder does not load ({native.load_error()}) "
            f"and cv2 is not installed ({e})"
        ) from None
    return cv2


def _read_video_frames(path: str, indices: list[int]) -> list[np.ndarray]:
    """Decode a container keeping the (sorted) ``indices``, BGR uint8: the
    native decoder first, then cv2 (on any decoder-level failure too)."""
    if native.available():
        try:
            with native.NativeDecoder(path) as dec:
                return list(dec.decode_selected(indices))
        except ValueError as e:
            log.info("native decode of %s failed (%s); trying cv2", path, e)
    cv2 = _cv2(path)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    want, last = set(indices), max(indices) if indices else -1
    out: dict[int, np.ndarray] = {}
    n = 0
    try:
        while n <= last:
            ok, frame = cap.read()
            if not ok:
                break
            if n in want:
                out[n] = frame
            n += 1
    finally:
        cap.release()
    return [out[i] for i in sorted(out)]


def probe_video(path: str) -> dict:
    """width, height, framerate, nb_frames, pixfmt, bitdepth, bitrate of a
    container (the ffprobe fields): the native decoder first (codec
    parameters), else cv2 (bitrate from the file size, 8-bit yuv420p
    assumed)."""
    if native.available():
        try:
            with native.NativeDecoder(path) as dec:
                if dec.nb_frames > 0:
                    return {"width": dec.width, "height": dec.height, "framerate": dec.framerate,
                            "nb_frames": dec.nb_frames, "pixfmt": dec.pixfmt or "yuv420p",
                            "bitdepth": dec.bitdepth or 8, "bitrate": dec.bitrate}
        except ValueError as e:
            log.info("native probe of %s failed (%s); trying cv2", path, e)
    cv2 = _cv2(path)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        nb = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        return {
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "framerate": fps, "nb_frames": nb, "pixfmt": "yuv420p", "bitdepth": 8,
            "bitrate": int(os.path.getsize(path) * 8 * fps / nb) if nb > 0 and fps > 0 else None,
        }
    finally:
        cap.release()


# ------------------------------------------------------------------ decoders
def _plan(path: str, framerate, width, height, pairs_only: bool = False):
    """(is_yuv, width, height, sampled indices, pair indices, flat sorted
    set to decode) for a file; the one place of the geometry rule.  A raw
    ``.yuv`` file needs its frame rate, width and height (metadata values,
    cleaned by :func:`_clean_meta`), and its size gives the frame count.  A
    container is probed once: the stream's width, height and frame count,
    and its frame rate where none is given."""
    is_yuv = path.endswith(".yuv")
    framerate, width, height = (_clean_meta(v) for v in (framerate, width, height))
    if is_yuv:
        missing = [k for k, v in (("framerate", framerate), ("width", width), ("height", height)) if v is None]
        if missing:
            raise ValueError(f"{path}: a raw .yuv file needs its framerate, width and height; "
                             f"{missing} not given")
        width, height = int(float(width)), int(float(height))
        n = _yuv420_frame_count(path, width, height)
    else:
        info = probe_video(path)
        framerate = info["framerate"] if framerate is None else framerate
        width, height, n = info["width"], info["height"], info["nb_frames"]
    interval = frame_interval_for(float(framerate))
    firsts = sample_indices(n, interval)
    pairs = residual_pair_indices(n, interval)
    flat = {i for p in pairs for i in p} | (set() if pairs_only else set(firsts))
    return is_yuv, width, height, firsts, pairs, sorted(flat)


def _decode_bgr(path: str, is_yuv: bool, width, height, flat: list[int]) -> dict:
    frames = _read_yuv420_frames(path, width, height, flat) if is_yuv else _read_video_frames(path, flat)
    return dict(zip(flat, frames))


def decode_sampled_frames(path: str, framerate: float | None = None,
                          width: int | None = None, height: int | None = None) -> np.ndarray:
    """Sampled full frames -> (B, H, W, 3) uint8 BGR."""
    is_yuv, width, height, firsts, _, _ = _plan(path, framerate, width, height)
    frames = _read_yuv420_frames(path, width, height, firsts) if is_yuv else _read_video_frames(path, firsts)
    return np.stack(frames)


def decode_video_inputs(path: str, framerate: float | None = None, width: int | None = None,
                        height: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(frames, prev, nxt) uint8 BGR in one decode pass of the set {k*i} U
    {k*i+1}.  The pairs' first frames are a prefix of the sampled frames,
    so ``prev`` is a prefix view of ``frames`` (the BGR program uploads the
    stack once).  A clip with no pairs raises at the pair stack, as the JAX
    package's does."""
    is_yuv, width, height, firsts, pairs, flat = _plan(path, framerate, width, height)
    lookup = _decode_bgr(path, is_yuv, width, height, flat)
    frames = np.stack([lookup[i] for i in firsts if i in lookup])
    pairs = [(a, b) for a, b in pairs if a in lookup and b in lookup]
    kept_firsts = [i for i in firsts if i in lookup]
    if [a for a, _ in pairs] == kept_firsts[: len(pairs)]:
        prev = frames[: len(pairs)]
    else:
        prev = np.stack([lookup[a] for a, _ in pairs])
    nxt = np.stack([lookup[b] for _, b in pairs])
    return frames, prev, nxt


def decode_frame_pairs(path: str, framerate: float | None = None, width: int | None = None,
                       height: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(prev, next) sampled pairs -> two (B, H, W, 3) uint8 BGR arrays."""
    is_yuv, width, height, _, pairs, flat = _plan(path, framerate, width, height, pairs_only=True)
    lookup = _decode_bgr(path, is_yuv, width, height, flat)
    pairs = [(a, b) for a, b in pairs if a in lookup and b in lookup]
    return np.stack([lookup[a] for a, _ in pairs]), np.stack([lookup[b] for _, b in pairs])


def decode_video_inputs_i420(path: str, framerate: float | None = None, width: int | None = None,
                             height: int | None = None) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(frames_i420, next_i420, h, w): packed I420 stacks (n, H*W*3/2) of
    the sampled frames and of the pairs' second frames (the pairs' first
    frames are the sampled frames, so two stacks carry everything).

    A raw ``.yuv`` file is read with numpy and needs the frame rate and the
    geometry.  A container needs the native decoder and even dimensions,
    and its stream must have the geometry that ``width`` and ``height`` give
    where they are given (this path cannot rescale); otherwise it raises
    :class:`I420Unavailable`, and the caller may decode BGR instead.
    """
    if not path.endswith(".yuv") and not native.available():
        raise I420Unavailable(f"I420 ingest needs the native decoder: {native.load_error()}")
    is_yuv, w, h, firsts, pairs, flat = _plan(path, framerate, width, height)
    if is_yuv:
        if w % 2 or h % 2:
            raise ValueError(f"I420 needs even dimensions, got {w}x{h}")
        return read_i420_frames(path, w, h, firsts), read_i420_frames(path, w, h, [b for _, b in pairs]), h, w
    width, height = _clean_meta(width), _clean_meta(height)
    if (width is not None and int(float(width)) != w) or (height is not None and int(float(height)) != h):
        raise I420Unavailable(f"metadata geometry {width}x{height} != decoded {w}x{h} for {path}")
    try:
        with native.NativeDecoder(path) as dec:
            buf = dec.decode_selected_i420(flat)
            h, w = dec.height, dec.width
    except ValueError as e:  # odd dimensions or a pixel format with no I420 form
        raise I420Unavailable(str(e)) from e
    pos = {idx: k for k, idx in enumerate(flat[: len(buf)])}
    fsel = [pos[i] for i in firsts if i in pos]
    nsel = [pos[b] for a, b in pairs if a in pos and b in pos]
    return buf[fsel], buf[nsel], h, w


def decode_video(path: str, framerate=None, width=None, height=None, ingest: str = "bgr"):
    """Decode ``path`` for the program that gives the JAX package's result
    -> ``("i420", (frames_i420, next_i420, h, w))`` for
    ``FeatureExtractor.video_feature_async_i420`` or ``("bgr", (frames,
    prev, nxt))`` for ``video_feature_async``.

    A raw ``.yuv`` file decodes as the JAX package decodes it in every
    ingest mode: BGR from the native rawvideo decoder when that loads; else
    the numpy reader's I420 stacks, which the device converts bit-identically
    to the numpy converter.  A clip with no pairs raises there too, as the
    JAX package's BGR decode does.  A container: ``yuv`` decodes I420 or
    raises; ``auto`` tries I420 and decodes BGR where the decoder cannot
    give I420 (logged); ``bgr`` decodes BGR.
    """
    if ingest not in ("bgr", "yuv", "auto"):
        raise ValueError(f"ingest is bgr, yuv or auto, got {ingest!r}")
    if path.endswith(".yuv"):
        if native.available():
            return "bgr", decode_video_inputs(path, framerate, width, height)
        fbuf, nbuf, h, w = decode_video_inputs_i420(path, framerate, width, height)
        if len(nbuf) == 0:
            raise ValueError(f"{path}: no frame pairs (the BGR decode's pair stack is empty)")
        return "i420", (fbuf, nbuf, h, w)
    if ingest in ("yuv", "auto"):
        try:
            return "i420", decode_video_inputs_i420(path, framerate, width, height)
        except I420Unavailable as e:
            if ingest == "yuv":
                raise
            log.info("I420 ingest unavailable for %s (%s); decoding BGR", path, e)
    return "bgr", decode_video_inputs(path, framerate, width, height)

"""ctypes binding of the prebuilt libav decoder ``native/librelaxdecode.so``
(own copy of ``relaxtpu/io/native.py:29-179``).

The library decodes a container (or a headerless ``.yuv`` stream) in
process and writes BGR24 or packed I420 straight into numpy buffers; the
ctypes calls release the GIL, so decode threads overlap the device.

Nothing loads at import.  The first call of :func:`available` (or the first
:class:`NativeDecoder`) loads the library once; where it cannot load (no
file, or no libav on the host) :func:`available` is False from then on and
:func:`load_error` says why.  The library is never built here: it is built
by ``native/build.sh``, outside this package.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "librelaxdecode.so",
)

_C = ctypes
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
# C signatures: name -> (restype, argtypes)
_SIGNATURES = {
    "relax_open": (_C.c_void_p, [_C.c_char_p]),
    "relax_open_raw": (_C.c_void_p, [_C.c_char_p, _C.c_int, _C.c_int, _C.c_char_p, _C.c_double]),
    "relax_info": (_C.c_int, [_C.c_void_p, _C.POINTER(_C.c_int), _C.POINTER(_C.c_int),
                              _C.POINTER(_C.c_double), _I64P]),
    "relax_info_ex": (_C.c_int, [_C.c_void_p, _C.c_char_p, _C.c_int, _C.POINTER(_C.c_int), _I64P]),
    "relax_decode_selected": (_C.c_int64, [_C.c_void_p, _I64P, _C.c_int64, _U8P]),
    "relax_decode_selected_yuv": (_C.c_int64, [_C.c_void_p, _I64P, _C.c_int64, _U8P]),
    "relax_close": (None, [_C.c_void_p]),
}

_lock = threading.Lock()
_state: dict = {}  # "lib": the loaded CDLL, or "error": why it cannot load


def _load() -> ctypes.CDLL | None:
    with _lock:
        if not _state:
            try:
                lib = ctypes.CDLL(LIB_PATH)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _state["lib"] = lib
            except (OSError, AttributeError) as e:  # no file, no libav, or an old build
                _state["error"] = f"{LIB_PATH}: {e}"
        return _state.get("lib")


def available() -> bool:
    """True when the decoder library loads on this host."""
    return _load() is not None


def load_error() -> str | None:
    """Why the library does not load (None when it does)."""
    _load()
    return _state.get("error")


class NativeDecoder:
    """One open video.  ``raw`` opens a headerless ``.yuv`` stream and must
    carry ``width`` and ``height`` (and may carry ``pixfmt``, default
    yuv420p, and ``framerate``, default 30)."""

    def __init__(self, path: str, raw: dict | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"the native decoder does not load: {load_error()}")
        self._lib = lib
        if raw is not None:
            self._h = lib.relax_open_raw(
                path.encode(), int(raw["width"]), int(raw["height"]),
                str(raw.get("pixfmt", "yuv420p")).encode(), float(raw.get("framerate") or 30.0),
            )
        else:
            self._h = lib.relax_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open video: {path}")
        w, h, fps, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_double(), ctypes.c_int64()
        lib.relax_info(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps), ctypes.byref(nf))
        self.width, self.height, self.framerate, self.nb_frames = w.value, h.value, fps.value, int(nf.value)
        pixfmt, depth, rate = ctypes.create_string_buffer(64), ctypes.c_int(), ctypes.c_int64()
        lib.relax_info_ex(self._h, pixfmt, 64, ctypes.byref(depth), ctypes.byref(rate))
        self.pixfmt = pixfmt.value.decode() or None
        self.bitdepth = depth.value or None
        self.bitrate = int(rate.value) or None

    def _decode(self, fn, indices, row_shape: tuple) -> np.ndarray:
        idx = np.asarray(sorted(indices), np.int64)
        out = np.empty((len(idx), *row_shape), np.uint8)
        n = fn(self._h, idx.ctypes.data_as(_I64P), len(idx), out.ctypes.data_as(_U8P))
        return out[: int(n)] if n >= 0 else None

    def decode_selected(self, indices) -> np.ndarray:
        """The (sorted) frame indices -> (n, H, W, 3) uint8 BGR; n falls
        short of the indices asked for where the stream ends first."""
        out = self._decode(self._lib.relax_decode_selected, indices, (self.height, self.width, 3))
        if out is None:
            raise ValueError("BGR decode failed (unconvertible pixel format)")
        return out

    def decode_selected_i420(self, indices) -> np.ndarray:
        """The (sorted) frame indices -> packed I420 (n, H*W*3/2) uint8: per
        frame H*W luma, then U and V at (H/2, W/2).  Needs even dimensions."""
        if self.width % 2 or self.height % 2:
            raise ValueError("YUV ingest needs even frame dimensions")
        out = self._decode(self._lib.relax_decode_selected_yuv, indices, (self.height * self.width * 3 // 2,))
        if out is None:
            raise ValueError("YUV decode failed (odd dimensions or unconvertible pixel format)")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.relax_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

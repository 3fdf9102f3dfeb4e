"""Build and bind the hand-written Hopper kernels (``relaxtpu_torch/csrc``).

The ``.cu`` files have a plain C interface.  At first use, one ``nvcc`` per
source compiles for ``sm_90a`` (all started together), one more links the
objects into a shared library under ``build/relaxtpu_torch/`` in the
checkout (named by a hash of the sources, so an edit rebuilds), and
``ctypes`` loads it.  Nothing here runs at import: the CPU-only test host
has no ``nvcc``.

Every C entry point that launches takes device pointers and the CUDA
stream as ``void*``, launches on that stream, and returns
``cudaGetLastError()``; a query (``_QUERIES``) launches nothing and returns
an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = ("warp.cu", "boxsolve.cu", "attention.cu")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_ROOT, "build", "relaxtpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: (argtypes) -> int (a cudaError_t)
_SIGNATURES = {
    "relax_update_matrices": (_P, _P, _P, _P, _I, _I, _I, _P),
    "relax_box_blur_solve": (_P, _P, _I, _I, _I, _I, _P),
    "relax_box_blur_solve_generic": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "relax_box_blur_solve_wide": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "relax_mha_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
    "relax_mha_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
    "relax_mha_f32_long": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
    "relax_mha_bf16_long": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _P),
}

# queries: (argtypes) -> int
_QUERIES = {
    "relax_box_blur_solve_generic_slots": (_I,),
    "relax_box_blur_solve_wide_slots": (_I,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}  # name -> bound C function, filled when the library loads


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc at first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels (if this version is not built yet) -> .so path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"librelaxkernels-{_source_hash()}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)  # private to this build: builds may race
    objs, procs = [], []
    for src in _SOURCES:
        obj = os.path.join(work, src.replace(".cu", ".o"))
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", os.path.join(_CSRC, src), "-o", obj]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        with open(os.path.join(BUILD_DIR, src + ".log"), "w") as f:
            f.write(out)
        if p.returncode != 0:
            failed.append(f"{src}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = os.path.join(work, "lib.so")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    shutil.rmtree(work, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in (_SIGNATURES | _QUERIES).items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _fns[name] = fn
            _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call a C entry point with ``device`` (the device of the tensors it
    reads) as the current device, on its current stream; raise on a CUDA
    error.  A ``<<<>>>`` launch goes to the current device, and the
    library's per-device set-up reads it (``csrc/per_device.cuh``)."""
    fn = _fns.get(name) or getattr(lib(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def query(name: str, device: torch.device, *args) -> int:
    """A query's result, with ``device`` current."""
    fn = _fns.get(name) or getattr(lib(), name)
    with torch.cuda.device(device):
        return fn(*args)


def check_cuda_input(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

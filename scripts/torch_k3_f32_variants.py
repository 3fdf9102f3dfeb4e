"""The long f32 K3 kernel (one pass, online rescaling) against variants of
itself, on one card.

    python scripts/torch_k3_f32_variants.py [--out build/k3_f32_variants.json]

Each variant is ``relaxtpu_torch/csrc/attention.cu`` with one design choice
of ``mha_f32_online_kernel`` changed by a text substitution, built with nvcc
into ``build/k3_f32_variants/`` (all builds started together) and bound with
ctypes:

- ``online``: the source as it is (128 queries a block, 4 queries x 8 keys
  a thread, one K and one V buffer: V lands during a tile's scores and the
  next tile's K during its P V, two barriers a tile; ``__launch_bounds__``
  asking for 2 blocks an SM, so at most 128 registers; ``ex2.approx``);
- ``q48`` and ``q64``: 48 and 64 queries a block (3 and 4 warps);
- ``regs_free`` and ``regs255``: ``__launch_bounds__`` naming no count of
  blocks (ptxas chooses), and asking for 1 (at most 255 registers);
- ``s_unroll1`` and ``s_unroll4``: the Q K^T loop over dims unrolled once
  and 4 times (the source: twice); ``pv_unroll4``: the P V loop over keys
  unrolled 4 times (the source: 8);
- ``keys32``: 32-key tiles, so 4 queries x 4 keys a thread in S (4 x 8
  output dims in P V as before);
- ``double``: two K and two V buffers, tile t + 1's K and V staged right
  after tile t's one barrier (twice the buffers' shared memory);
- ``single``: one K and one V buffer, a tile's K and V staged together after
  every warp is done with the last tile, so no copy overlaps compute;
- ``expf``: the exponentials by ``expf`` (full precision) in place of
  ``ex2.approx``;
- ``two_pass``: the two-pass kernel that D = 128 and 256 keep, at D = 32 and
  64 too (the long f32 entry as it was before the one-pass kernel).

Each is held against ``mha_plain`` (``TOL`` of chip_smoke, 1e-4 of max
|plain|) and timed by the profiler's device time and by CUDA events (ms a
call over 20 back-to-back calls) at ViT-B/16 384x384 (48, 577, 12, 64) and
at D = 32, in turns, beside ``F.scaled_dot_product_attention``.  Prints ptxas' registers and spills of
each variant's kernel, the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from relaxtpu_torch import _native  # noqa: E402
from relaxtpu_torch.ops.attention import mha_plain  # noqa: E402

CSRC = os.path.join(ROOT, "relaxtpu_torch", "csrc")
OUT_DIR = os.path.join(ROOT, "build", "k3_f32_variants")
SHAPES = ((48, 577, 12, 64), (48, 577, 12, 32))
TOL = 1e-4  # chip_smoke's TOL["K3_f32"], of max |plain|

PROLOGUE = """  stage_rows<float, D, F1_KT, THREADS>(kb, k, base, sn, 0, N);
  cp_async_commit();
"""
PROLOGUE_KV = """  stage_rows<float, D, F1_KT, THREADS>(kb, k, base, sn, 0, N);
  stage_rows<float, D, F1_KT, THREADS>(vb, v, base, sn, 0, N);
  cp_async_commit();
"""
SPLIT = """    cp_async_wait<0>();
    __syncthreads();  // K of tile it landed; every warp is done with V of tile it - 1
    stage_rows<float, D, F1_KT, THREADS>(vb, v, base, sn, key0, N);
    cp_async_commit();
    f1_tile<D, F1_KT / 8>(busy, qt, kb, vb, pw, acc, mc, lp, key0, N, c, qq, qy, kx, [=] {
      cp_async_wait<0>();
      __syncthreads();  // V landed; every warp is done with K
      if (it + 1 < tiles) {
        stage_rows<float, D, F1_KT, THREADS>(kb, k, base, sn, key0 + F1_KT, N);
        cp_async_commit();
      }
    });
"""
# K and V of tile it + 1 into the other buffer pair right after the one barrier of tile it
DOUBLE = """    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) {
      const int nb = ((it + 1) & 1) * TILE;
      stage_rows<float, D, F1_KT, THREADS>(kb + nb, k, base, sn, key0 + F1_KT, N);
      stage_rows<float, D, F1_KT, THREADS>(vb + nb, v, base, sn, key0 + F1_KT, N);
      cp_async_commit();
    }
    const int cb = (it & 1) * TILE;
    f1_tile<D, F1_KT / 8>(busy, qt, kb + cb, vb + cb, pw, acc, mc, lp, key0, N, c, qq, qy, kx, [] {});
"""
# K and V of tile it staged after every warp is done with tile it - 1: no copy overlaps compute
SINGLE = """    if (it) {
      __syncthreads();
      stage_rows<float, D, F1_KT, THREADS>(kb, k, base, sn, key0, N);
      stage_rows<float, D, F1_KT, THREADS>(vb, v, base, sn, key0, N);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    f1_tile<D, F1_KT / 8>(busy, qt, kb, vb, pw, acc, mc, lp, key0, N, c, qq, qy, kx, [] {});
"""


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"the kernel's source changed: {old[:60]!r} not found once")
        src = src.replace(old, new)
    return src


def variants() -> dict:
    src = open(os.path.join(CSRC, "attention.cu")).read()
    warps = "constexpr int F1_WARPS = 8; "
    bounds = "__launch_bounds__(32 * F1_WARPS, 2)\nmha_f32_online_kernel"
    s_loop = "#pragma unroll 2\n  for (int d = 0; d < D; d += 4) {\n    float4 a[4];"
    pv_loop = "#pragma unroll 8\n  for (int j = 0; j < 8 * MC; ++j) {"
    return {
        "online": src,
        "q48": substitute(src, [(warps, "constexpr int F1_WARPS = 3; ")]),
        "q64": substitute(src, [(warps, "constexpr int F1_WARPS = 4; ")]),
        "regs_free": substitute(src, [(bounds, "__launch_bounds__(32 * F1_WARPS)\nmha_f32_online_kernel")]),
        "regs255": substitute(src, [(bounds, "__launch_bounds__(32 * F1_WARPS, 1)\nmha_f32_online_kernel")]),
        "s_unroll1": substitute(src, [(s_loop, s_loop.replace("unroll 2", "unroll 1"))]),
        "s_unroll4": substitute(src, [(s_loop, s_loop.replace("unroll 2", "unroll 4"))]),
        "pv_unroll4": substitute(src, [(pv_loop, pv_loop.replace("unroll 8", "unroll 4"))]),
        "keys32": substitute(src, [("constexpr int F1_KT = 64; ", "constexpr int F1_KT = 32; ")]),
        "double": substitute(src, [("constexpr int F1_KV_TILES = 1; ", "constexpr int F1_KV_TILES = 2; "),
                                   (PROLOGUE, PROLOGUE_KV), (SPLIT, DOUBLE)]),
        "single": substitute(src, [(PROLOGUE, PROLOGUE_KV), (SPLIT, SINGLE)]),
        "expf": substitute(src, [("float f1_exp2(float x) { return ex2(x); }",
                                  "float f1_exp2(float x) { return expf(x * 0.6931471805599453f); }")]),
        "two_pass": substitute(src, [("if constexpr (D <= 64) {  // one pass;", "if constexpr (false) {  //")]),
    }


def build(srcs: dict) -> tuple[dict, dict]:
    """(name -> the bound relax_mha_f32_long of that variant's library,
    name -> ptxas' lines for its long f32 kernels)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", CSRC,
             "-o", os.path.join(OUT_DIR, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, regs = {}, {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name} did not build:\n{log[-4000:]}")
        fn = None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                fn = m.group(1)
            elif fn and re.search(r"mha_f32_(online|long)", fn) and ("Used" in line or "spill" in line):
                kernel = re.search(r"mha_f32_\w+?_kernel", fn).group(0)
                label = f"{kernel}<{','.join(re.findall(r'Li(\d+)E', fn))}>"
                text = line.split(":", 1)[-1].strip()
                regs.setdefault(name, {}).setdefault(label, []).append(text)
                print(f"  {name} {label}: {text}")
        c = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")).relax_mha_f32_long
        c.argtypes, c.restype = _native._SIGNATURES["relax_mha_f32_long"], ctypes.c_int
        fns[name] = c
    return fns, regs


def launch(fn, q, k, v, scale) -> torch.Tensor:
    b, n, h, d = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, d, q.stride(0), q.stride(1),
             scale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def device_ms(fn, passes: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / passes


def event_ms(fn, iters: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--rounds", type=int, default=3, help="turns over the variants at each shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # mha_plain in full f32
    fns, regs = build(variants())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        scale = shape[-1] ** -0.5
        want = mha_plain(q, k, v, scale)
        rec = out[str(shape)] = {}
        for name, fn in fns.items():
            got = launch(fn, q, k, v, scale)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not rel <= TOL:
                raise SystemExit(f"{name} {shape}: error {rel} over {TOL} of max |plain|")
            rec[name] = {"rel_err": rel, "device_ms": [], "ms": []}
        rec["sdpa"] = {"device_ms": [], "ms": []}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        for _ in range(args.rounds):
            calls = {name: (lambda fn=fn: launch(fn, q, k, v, scale)) for name, fn in fns.items()}
            calls["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
            for name, call in calls.items():
                rec[name]["device_ms"].append(device_ms(call))
                rec[name]["ms"].append(event_ms(call))
        for name, r in rec.items():
            print(f"  {shape} {name}: device ms {[round(x, 4) for x in r['device_ms']]}, "
                  f"ms by events {[round(x, 4) for x in r['ms']]}"
                  + (f", largest error / max |plain| {r['rel_err']:.2e}" if "rel_err" in r else ""))
        del q, k, v, qt, kt, vt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    record = {"card": card, "torch": torch.__version__, "ptxas": regs, "shapes": out}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

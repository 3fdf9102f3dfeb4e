"""The long bf16 K3 ring kernel against variants of itself, on one card.

    python scripts/torch_k3_ring_variants.py [--out build/k3_ring_variants.json]

Each variant is the ring kernel of ``relaxtpu_torch/csrc/attention.cu`` with
one design choice changed by a text substitution, built with nvcc into
``build/k3_ring_variants/`` (all builds started together) and bound with
ctypes:

- ``ring``: the source as it is (every copy a 16-byte cp.async completing
  on an mbarrier; 3 blocks an SM);
- ``bulk_kv``: K and V by one bulk copy (``cp.async.bulk``, the TMA without
  a tensor map) a token row, completing on the stage's mbarrier;
- ``bulk_q``: Q by one bulk copy a row, on its warp's mbarrier;
- ``two_blocks``: 2 blocks an SM (a 4-stage ring, up to 255 registers).

Each is held against ``mha_plain`` (``TOL`` of chip_smoke) and timed by the
profiler's device time at ViT-B/16 384x384 (48, 577, 12, 64), the 224x224
shape (48, 197, 12, 64) and D = 32, in turns, beside
``F.scaled_dot_product_attention``.  Prints ptxas' registers and spills of
each variant's ring kernel, the card's name and power limit, and one JSON
line.
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
OUT_DIR = os.path.join(ROOT, "build", "k3_ring_variants")
SHAPES = ((48, 577, 12, 64), (48, 197, 12, 64), (48, 577, 12, 32))
TOL = 2e-2  # chip_smoke's TOL["K3_bf16"], of max |plain|

CP_ASYNC_KV = """#pragma unroll
    for (int r = 0; r < RK / RPASS; ++r) {
      if (lrow + r * RPASS >= rows) break;
      cp_async16(ks + r * RPASS * LD, k + off + r * RPASS * sn);
      if (with_v) cp_async16(ks + (RK + r * RPASS) * LD, v + off + r * RPASS * sn);
    }
    cp_async_arrive(full0 + 8 * st);
"""
BULK_KV = """    const int mine = (int)threadIdx.x < rows ? (with_v ? 2 : 1) : 0;  // rows of this thread
    mbar_expect_tx(full0 + 8 * st, mine * ROW);
    if (mine) {
      bf16* const kd = ring + 2 * st * RK * LD + threadIdx.x * LD;
      const long long ro = base + (long long)(key0 + threadIdx.x) * sn;
      bulk_copy(smem_addr(kd), k + ro, ROW, full0 + 8 * st);
      if (with_v) bulk_copy(smem_addr(kd + RK * LD), v + ro, ROW, full0 + 8 * st);
    }
"""
ZEROS_DONE = "  __syncthreads();\n\n  // Load l (l < 2 tiles)"
Q_CP_ASYNC = """  for (int c = lane; c < 32 * CH; c += 32) {
    const int r = 32 * warp + c / CH;
    if (r < qrows) cp_async16(qs + r * LD + (c % CH) * 8, q + base + (long long)(q0 + r) * sn + (c % CH) * 8);
  }
  cp_async_arrive(qbar0 + 8 * warp);
"""
Q_BULK = """  if (lane == 0) mbar_expect_tx(qbar0 + 8 * warp, max(0, min(32, qrows - 32 * warp)) * ROW);
  __syncwarp();
  if (threadIdx.x < qrows)
    bulk_copy(smem_addr(qs + threadIdx.x * LD), q + base + (long long)(q0 + threadIdx.x) * sn, ROW,
              qbar0 + 8 * warp);
"""
# the bulk copy and its mbarrier arrival, ahead of the ring kernel; ROW: bytes a token row
BULK_HELPERS = """__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
"""
HELPERS_AT = "// 2^x by the SFU alone"
ROW_AT = "  constexpr int CH = D / 8;                   // 16-byte chunks a row\n"
BULK = [(HELPERS_AT, BULK_HELPERS + HELPERS_AT),
        (ROW_AT, ROW_AT + "  constexpr int ROW = D * (int)sizeof(bf16);\n")]


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"the ring kernel's source changed: {old[:60]!r} not found once")
        src = src.replace(old, new)
    return src


def variants() -> dict:
    src = open(os.path.join(CSRC, "attention.cu")).read()
    return {
        "ring": src,
        "bulk_kv": substitute(src, BULK + [(CP_ASYNC_KV, BULK_KV),  # generic zeros before async-proxy writes
                                           (ZEROS_DONE, '  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
                                            + ZEROS_DONE)]),
        "bulk_q": substitute(src, BULK + [(Q_CP_ASYNC, Q_BULK),
                                          ("mbar_init(qbar0 + 8 * w, 32);", "mbar_init(qbar0 + 8 * w, 1);")]),
        "two_blocks": substitute(src, [("__launch_bounds__(RTHREADS, 3)", "__launch_bounds__(RTHREADS, 2)"),
                                       ("constexpr int RSTAGES = 3; ", "constexpr int RSTAGES = 4; ")]),
    }


def build(srcs: dict) -> dict:
    """name -> the bound relax_mha_bf16_long of that variant's library."""
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
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name} did not build:\n{log[-4000:]}")
        fn = None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                fn = m.group(1)
            elif fn and "mha_bf16_ring" in fn and ("Used" in line or "spill" in line):
                print(f"  {name} ring<{','.join(re.findall(r'Li(\d+)E', fn))}>: {line.split(':', 1)[-1].strip()}")
        c = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so")).relax_mha_bf16_long
        c.argtypes, c.restype = _native._SIGNATURES["relax_mha_bf16_long"], ctypes.c_int
        fns[name] = c
    return fns


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--rounds", type=int, default=3, help="turns over the variants at each shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    fns = build(variants())
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = shape[-1] ** -0.5
        want = mha_plain(q, k, v, scale).float()
        rec = out[str(shape)] = {}
        for name, fn in fns.items():
            got = launch(fn, q, k, v, scale).float()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not rel <= TOL:
                raise SystemExit(f"{name} {shape}: error {rel} over {TOL} of max |plain|")
            rec[name] = {"rel_err": rel, "device_ms": []}
        rec["sdpa"] = {"device_ms": []}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        for _ in range(args.rounds):
            for name, fn in fns.items():
                rec[name]["device_ms"].append(device_ms(lambda: launch(fn, q, k, v, scale)))
            rec["sdpa"]["device_ms"].append(
                device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)))
        for name, r in rec.items():
            print(f"  {shape} {name}: device ms {[round(x, 4) for x in r['device_ms']]}"
                  + (f", largest error / max |plain| {r['rel_err']:.2e}" if "rel_err" in r else ""))
        del q, k, v, qt, kt, vt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    record = {"card": card, "torch": torch.__version__, "shapes": out}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

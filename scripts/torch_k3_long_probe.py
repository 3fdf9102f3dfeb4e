"""A short first call for a long K3 entry on one card: build, ptxas,
correctness over the edges of its blocks and tiles, and its time.

    python scripts/torch_k3_long_probe.py [--dtype bf16|f32] [--time]
    python scripts/torch_k3_long_probe.py --time --parent build/parent

Builds the kernel library of the checkout (or, with ``--parent DIR``, of the
``relaxtpu_torch`` package under DIR: another commit's, unpacked there with
``git archive``), prints the registers and spills ptxas gives the long
entries' kernels of that type, and holds ``relax_mha_<dtype>_long`` against
``mha_plain`` within chip_smoke's ``TOL`` of max |plain| (2e-2 in bf16, 1e-4
in f32) at N in 1..2049 around multiples of 8 to 128 and D in {32, 64, 128}, on contiguous and
packed-qkv inputs that sit in NaN-filled allocations (the checkout only).
``--time``: the entry's ms by events and device ms by the profiler at
(48, N, 12, 64) for N in {577, 197, 1025}, beside SDPA's.  Exits 1 on a
disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_NS = (1, 5, 8, 9, 16, 17, 31, 32, 33, 63, 64, 65, 72, 73, 127, 128, 129, 191, 192, 193, 197, 255, 256,
           257, 300, 383, 384, 385, 577, 640, 641, 1025, 2049)
TOL = {"bf16": 2e-2, "f32": 1e-4}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def nan_padded(t: torch.Tensor) -> torch.Tensor:
    buf = torch.full((t.numel() + 4096,), float("nan"), dtype=t.dtype, device=t.device)
    buf[: t.numel()].copy_(t.reshape(-1))
    return buf[: t.numel()].view(t.shape)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bf16", help="the long entry's type")
    ap.add_argument("--time", action="store_true", help="also time the entry at ViT-B/16 shapes")
    ap.add_argument("--parent", default=None, help="a directory holding another commit's relaxtpu_torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.parent) if args.parent else ROOT)
    from relaxtpu_torch import _native
    from relaxtpu_torch.ops import attention as A

    t0 = time.perf_counter()
    _native.lib()
    print(f"{A.__file__}: built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tag, dtype = args.dtype, DTYPES[args.dtype]
    entry = f"relax_mha_{tag}_long"
    bad = 0
    if not args.parent:
        name = None
        for line in open(os.path.join(_native.BUILD_DIR, "attention.cu.log")):
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                name = m.group(1)
            elif (name and f"mha_{tag}_" in name and any(w in name for w in ("long", "ring", "online"))
                  and ("Used" in line or "spill" in line)):
                kernel = re.search(rf"mha_{tag}_\w+?_kernel", name).group(0)
                print(f"  {kernel}<{','.join(re.findall(r'Li(\d+)E', name))}>: {line.split(':', 1)[-1].strip()}")
        for n in EDGE_NS:
            for d in (32, 64, 128):
                b, h = 2, 3
                qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
                q, k, v = (nan_padded(qkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)) for i in range(3))
                want = A.mha_plain(q, k, v, d**-0.5)
                packed = nan_padded(qkv)
                qp, kp, vp = (packed[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
                got = [A._launch(*t, d**-0.5, entry) for t in ((q, k, v), (qp, kp, vp))]
                torch.cuda.synchronize()
                errs = [rel(x, want) for x in got]
                ok = max(errs) <= TOL[tag] and all(torch.isfinite(x).all().item() for x in got)
                bad += not ok
                print(f"  {tag} long N={n} D={d}: error / max |plain| {errs[0]:.2e} contiguous, "
                      f"{errs[1]:.2e} packed {'ok' if ok else 'FAIL'}", flush=True)
    if args.time and not bad:
        for n in (577, 197, 1025):
            q, k, v = (torch.randn((48, n, 12, 64), generator=gen, device="cuda").to(dtype) for _ in range(3))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            fn = lambda: A._launch(q, k, v, 0.125, entry)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=0.125)  # noqa: E731
            r = {"rel_err": rel(fn(), A.mha_plain(q, k, v, 0.125)), "ms": ms(fn), "device_ms": device_ms(fn),
                 "sdpa_ms": ms(sdpa), "sdpa_device_ms": device_ms(sdpa)}
            print(f"  TIME {'parent' if args.parent else 'checkout'} {tag} (48, {n}, 12, 64) {json.dumps(r)}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"disagreements: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""The generic-radius K2 kernel (box blur + 2x2 solve, one launch, windows 19
to 65, the route of 19 and 21) against variants of itself and against the
wide route's pair of kernels, on one card.

    python scripts/torch_k2_generic_variants.py [--out build/k2_generic_variants.json]
        [--variants ring,th8,...] [--windows 19,21,31,63] [--rounds 3]

Each variant is ``relaxtpu_torch/csrc/boxsolve.cu`` with one design choice
of ``box_ring_solve_kernel`` changed by a text substitution, built with nvcc
into ``build/k2_generic_variants/`` (all builds started together) and bound
with ctypes; its plan is ``ops.boxsolve._ring_plan`` at the variant's rows a
step and span:

- ``ring``: the source as it is (16 output rows a step, a 128-column span,
  each plane's ring 16 + 2R rows, the planes staged in turn: plane c's next
  rows right after the step's vertical pass of plane c; at most 128
  registers, 2 blocks an SM where shared memory allows);
- ``th8``: 8 output rows a step (4 rows a thread in the vertical pass, one
  4-pixel run a thread in the horizontal one);
- ``span64`` and ``span256``: a 64-column span (16 rows a step), and a
  256-column span at 8 rows a step (narrower and wider strips);
- ``together``: the planes staged together: rings of 2 x 16 + 2R rows, all
  five planes' next rows staged at the start of each step, one barrier a
  step more;
- ``regs_free``: ``__launch_bounds__`` naming no count of blocks (ptxas
  chooses the registers);
- ``pair``: the wide route (``relax_box_blur_solve_wide`` on the plan of
  ``_wide_plan``: a vertical ring pass into a scratch buffer, then a staged
  horizontal pass fused with the solve), from the ``ring`` library;
  ``strip15``: the strip kernel at winsize 15, for scale.

Each is held against ``box_blur_solve_plain`` at the 540p pyramid levels (16
pairs) and at ragged shapes (widths 1, 3, a strip less one, a strip and one
more, 131; heights 1 and below the window; an input offset by one float),
its largest |kernel - plain| printed, and timed on the four 540p levels (a
pass; x 3 is the main path's 12 calls) at winsizes 19, 21, 31 and 63 by the
profiler's device time (each call profiled on its own, each kernel function
timed by the mean of its records kept, the records counted against the
launches) and by CUDA events, in turns.  A variant whose span or shared memory cannot take
a window is skipped there.  Prints ptxas' registers and spills of each
variant's kernel, the card's name and power limit, and one JSON line.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from relaxtpu_torch import _native  # noqa: E402
from relaxtpu_torch.ops.boxsolve import _ring_plan, _wide_plan, _wide_taps, box_blur_solve_plain  # noqa: E402
from relaxtpu_torch.ops.flow import pyramid_levels  # noqa: E402

CSRC = os.path.join(ROOT, "relaxtpu_torch", "csrc")
OUT_DIR = os.path.join(ROOT, "build", "k2_generic_variants")
PAIRS, H, W = 16, 540, 960
TOL = 1e-4  # chip_smoke's TOL["K2"], of max |plain|

TH16, SPAN128, RMAX = "constexpr int GTH = 16; ", "constexpr int GRS = 128; ", "constexpr int GRMAX = 32; "
BOUNDS = "__launch_bounds__(GT, 2)\nbox_ring_solve_kernel"
ROWS = "__host__ __device__ static constexpr int rows(int R) { return (TH + 2 * R + 3) & ~3; }"
IN_TURN = """      cp_async_wait<3>();
      __syncthreads();
      if (k + 1 < steps)
        ring_rows<RS>(ring, mp + c * hw, H, W, ys - R + TH * (k + 1) + 2 * R, x0 - r4, span, TH, fill,
                      rows, vec);
      cp_async_commit();  // every trip, so the count of groups in flight stays 3
"""
STEP = "    const int fill = (TH * (k + 1) + 2 * R) % rows;  // the slot of the next step's first new row\n"
# all five planes' next rows at the start of a step, after every thread is done with the last one
TOGETHER_STEP = STEP + """    cp_async_wait<0>();
    __syncthreads();
    if (k + 1 < steps) {
#pragma unroll
      for (int c = 0; c < 5; ++c)
        ring_rows<RS>(smem + c * rows * RS, mp + c * hw, H, W, ys - R + TH * (k + 1) + 2 * R, x0 - r4,
                      span, TH, fill, rows, vec);
    }
    cp_async_commit();
"""
# name -> (substitutions, rows a step, span, largest radius)
VARIANTS = {
    "ring": ([], 16, 128, 32),
    "th8": ([(TH16, "constexpr int GTH = 8; ")], 8, 128, 32),
    "span64": ([(SPAN128, "constexpr int GRS = 64; ")], 16, 64, 32),
    "span256": ([(TH16, "constexpr int GTH = 8; "), (SPAN128, "constexpr int GRS = 256; "),
                 (RMAX, "constexpr int GRMAX = 16; ")], 8, 256, 16),
    "together": ([(ROWS, ROWS.replace("(TH + 2 * R", "(2 * TH + 2 * R")), (IN_TURN, "      __syncthreads();\n"),
                  (STEP, TOGETHER_STEP), (RMAX, "constexpr int GRMAX = 26; ")], 16, 128, 26),
    "regs_free": ([(BOUNDS, "__launch_bounds__(GT)\nbox_ring_solve_kernel")], 16, 128, 32),
}


def substitute(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"the kernel's source changed: {old[:60]!r} not found once")
        src = src.replace(old, new)
    return src


def build(names: list) -> tuple[dict, dict]:
    """(name -> its ctypes library, name -> ptxas' lines for its generic
    kernel), every variant built at once."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = open(os.path.join(CSRC, "boxsolve.cu")).read()
    procs = {}
    for name in names:
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(substitute(src, VARIANTS[name][0]))
        procs[name] = subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", CSRC,
             "-o", os.path.join(OUT_DIR, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name} did not build:\n{log[-4000:]}")
        fn = None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                fn = m.group(1)
            elif fn and "box_ring_solve" in fn and ("Used" in line or "spill" in line or "stack" in line):
                text = line.split(":", 1)[-1].strip()
                regs.setdefault(name, []).append(text)
                print(f"  {name} box_ring_solve_kernel: {text}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so"))
        for entry in ("relax_box_blur_solve_generic", "relax_box_blur_solve_wide", "relax_box_blur_solve"):
            getattr(lib, entry).argtypes = _native._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        for query in ("relax_box_blur_solve_generic_slots", "relax_box_blur_solve_wide_slots"):
            getattr(lib, query).argtypes = [ctypes.c_int]
            getattr(lib, query).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def runner(lib, name: str, ws: int):
    """m -> flow by variant ``name`` of ``lib`` at winsize ``ws``; None where
    the variant cannot take the window."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err):
        if err:
            raise RuntimeError(f"{name} winsize {ws}: CUDA error {err}")

    if name == "pair":
        slots = lib.relax_box_blur_solve_wide_slots(_wide_taps(ws))

        def run(m):
            p, _, h, w = m.shape
            plan = _wide_plan(p, h, w, ws, slots)
            flow, scratch = m.new_empty((p, 2, h, w)), m.new_empty((p, 5, h, plan[0]))
            check(lib.relax_box_blur_solve_wide(m.data_ptr(), scratch.data_ptr(), flow.data_ptr(), p, h, w, ws, *plan,
                                                stream()))
            return flow
        return run
    if name == "strip15":
        def run(m):
            p, _, h, w = m.shape
            flow = m.new_empty((p, 2, h, w))
            check(lib.relax_box_blur_solve(m.data_ptr(), flow.data_ptr(), p, h, w, 15, stream()))
            return flow
        return run
    _, th, span, rmax = VARIANTS[name]
    r, r4 = ws // 2, ((ws // 2) + 3) & ~3
    if r > rmax or span - 2 * r4 < 4:
        return None
    slots = lib.relax_box_blur_solve_generic_slots(ws)
    if slots <= 0:
        raise RuntimeError(f"{name} winsize {ws}: slots query gave {slots}")

    def run(m):
        p, _, h, w = m.shape
        tw, seg, _ = _ring_plan(p, h, w, ws, slots, th=th, span=span)
        flow = m.new_empty((p, 2, h, w))
        check(lib.relax_box_blur_solve_generic(m.data_ptr(), flow.data_ptr(), p, h, w, ws, tw, seg, stream()))
        return flow
    return run


def nan_padded(t: torch.Tensor, at: int = 0) -> torch.Tensor:
    """A copy of ``t`` ``at`` floats into a larger NaN-filled allocation."""
    buf = torch.full((t.numel() + at + 4096,), float("nan"), device=t.device)
    buf[at : at + t.numel()].copy_(t.reshape(-1))
    return buf[at : at + t.numel()].view(t.shape)


def device_ms(fns: list, per_call: int, passes: int = 10, tries: int = 3) -> tuple[float | None, int]:
    """(device ms a pass over ``fns``, kernel records the profiler kept of
    len(fns) x passes x per_call).  Each call is profiled on its own and
    each of its kernel functions timed by the mean of its records kept: the
    profiler drops records now and then, at times all of a session's
    (chip_smoke.py's ``device_ms``).  A call whose records lack one of its
    functions is profiled again, ``tries`` times in all; then the ms is
    None."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total, kept = 0.0, 0
    for fn in fns:
        for _ in range(tries):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(passes):
                    fn()
                torch.cuda.synchronize()
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
            if len(by_name) == per_call:
                break
        else:
            return None, kept
        total += sum(sum(v) / len(v) for v in by_name.values())
        kept += sum(len(v) for v in by_name.values())
    return total / 1e3, kept


def event_ms(fns: list, iters: int = 20) -> float:
    for fn in fns:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        for fn in fns:
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--variants", default=",".join([*VARIANTS, "pair", "strip15"]))
    ap.add_argument("--windows", default="19,21,31,63")
    ap.add_argument("--rounds", type=int, default=3, help="turns over the variants at each window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    windows = [int(x) for x in args.windows.split(",")]
    built = [n for n in names if n in VARIANTS] or ["ring"]
    libs, regs = build(sorted(set(built) | {"ring"}))
    lib_of = {n: libs[n if n in VARIANTS else "ring"] for n in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    levels = [torch.randn((PAIRS, 5, h, w), generator=gen, device="cuda") * 50 for _, h, w in pyramid_levels(H, W)]
    out = {}
    for ws in windows:
        rec = out[ws] = {}
        runs = {n: runner(lib_of[n], n, ws) for n in names}
        runs = {n: f for n, f in runs.items() if f is not None}
        r4 = ((ws // 2) + 3) & ~3
        for name, run in runs.items():
            if name == "strip15":
                rec[name] = {"device_ms": [], "ms": [], "records": []}
                continue
            span = VARIANTS.get(name, (0, 0, 128))[2]
            strip = span - 2 * r4
            edges = [(1, 1, 1), (1, 5, 3), (1, ws - 2, strip - 1), (1, 1, strip), (1, 3, strip + 1),
                     (2, 37, 131)]
            err = 0.0
            for m in levels + [torch.randn((p, 5, h, w), generator=gen, device="cuda") * 50 for p, h, w in edges]:
                want = box_blur_solve_plain(m, ws)
                for at in (0, 1):
                    got = run(nan_padded(m, at))
                    e = (got - want).abs().max().item()
                    if not e <= TOL * want.abs().max().item():
                        raise SystemExit(f"{name} winsize {ws} {tuple(m.shape)} offset {at}: |kernel - plain| {e}")
                    err = max(err, e)
            rec[name] = {"max_abs_err": err, "device_ms": [], "ms": [], "records": []}
            print(f"  winsize {ws} {name}: largest |kernel - plain| {err} (540p levels, ragged shapes, "
                  f"aligned and offset by one float)")
        for _ in range(args.rounds):
            for name, run in runs.items():
                fns = [lambda m=m, run=run: run(m) for m in levels]
                ms, n = device_ms(fns, 2 if name == "pair" else 1)
                rec[name]["device_ms"].append(ms)
                rec[name]["records"].append(n)
                rec[name]["ms"].append(event_ms(fns))
        want_records = 10 * len(levels)
        for name, r in rec.items():
            per = 2 if name == "pair" else 1
            print(f"  winsize {ws} {name}: device ms a pass of 4 levels "
                  f"{[x if x is None else round(x, 4) for x in r['device_ms']]} "
                  f"(records {r['records']} of {per * want_records} launched), ms by events "
                  f"{[round(x, 4) for x in r['ms']]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    record = {"card": card, "torch": torch.__version__, "ptxas": regs, "windows": out}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

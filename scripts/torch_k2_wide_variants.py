"""The wide-window K2 route (box blur + 2x2 solve, windows above 21: a
vertical ring pass into a scratch buffer, then a staged horizontal pass
fused with the solve) against variants of itself and against the
generic-radius kernel, on one card.

    python scripts/torch_k2_wide_variants.py [--out build/k2_wide_variants.json]
        [--variants wide,th8,...] [--windows 63,65,67,101,131] [--rounds 3]
        [--parent build/parent_boxsolve.cu]

Each variant is ``relaxtpu_torch/csrc/boxsolve.cu`` with one design choice
of ``box_vsum_kernel`` or ``box_hsum_solve_kernel`` changed by a text
substitution (or, for a plan variant, the source as it is with another
plan), built with nvcc into ``build/k2_wide_variants/`` (all builds started
together) and bound with ctypes; its plan is ``ops.boxsolve._wide_plan`` at
the variant's rows a step, span and runs:

- ``wide``: the source as it is (the vertical pass: one plane a block, 16
  rows a step, a 128-column span, a ring of 32 + taps - 1 rows, at least 4
  blocks an SM; the horizontal pass: 256 threads of 2 runs of 4 pixels,
  whole rows of up to 2,048 columns staged, at least 3 blocks an SM);
- ``th8``: 8 rows a step of the vertical pass (4 rows a thread);
- ``span64`` and ``span256``: 64- and 256-column vertical strips (4 and 16
  rows a thread);
- ``runs256``: one run a thread in the horizontal pass (bands of half the
  rows);
- ``hblocks2`` and ``hblocks4``: the horizontal pass bounded for 2 and 4
  blocks an SM (more and fewer registers);
- ``chunk2``: the plan's vertical taps in two launches (a ring half as tall,
  the scratch read and written once more);
- ``planes5``: the horizontal pass taking the five planes in one tap loop
  (20 independent sums a thread, each plane's next 16-byte chunk loaded
  while the other four planes' taps run), one run a thread;
- ``ring``: the generic-radius kernel (``box_ring_solve_kernel``, one
  launch), at the windows it takes (up to 65); ``strip15``: the strip
  kernel at winsize 15, for scale;
- ``parent`` (with ``--parent``): the wide pair of another source of
  ``boxsolve.cu``, such as the commit before this design (its
  ``relax_box_blur_solve_wide(m, scratch, flow, P, H, W, winsize,
  stream)``) or an earlier version of this one (on this plan).

Each is held against ``box_blur_solve_plain`` at the 540p pyramid levels (16
pairs) and at ragged shapes (widths 1, 3, a strip less one, a strip and one
more, 131; heights 1 and below the window; an input offset by one float),
where it must be bit-identical (|kernel - plain| printed), and timed on the
four 540p levels (a pass; x 3 is the main path's 12 calls) by the
profiler's device time (each call profiled on its own, its records counted
against its launches, and each kernel function's share) and by CUDA
events, in turns.  Prints ptxas' registers and spills of each variant's two
kernels, the card's name and power limit, and one JSON line.
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
from torch_k2_generic_variants import event_ms, nan_padded, substitute  # noqa: E402

CSRC = os.path.join(ROOT, "relaxtpu_torch", "csrc")
OUT_DIR = os.path.join(ROOT, "build", "k2_wide_variants")
PAIRS, H, W = 16, 540, 960

VTH16, VRS128, HR2 = "constexpr int VTH = 16; ", "constexpr int VRS = 128; ", "constexpr int HR = 2; "
HBOUNDS = "__launch_bounds__(HT, 3)\nbox_hsum_solve_kernel"
HSUMS_CALL = """#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int e = 0; e < HR; ++e)
        if (hrow[e] < nb) hsums_from(acc[c][e], smem + (c * bh + hrow[e]) * ss + hx[e], n);
"""
HSUMS5_CALL = """#pragma unroll
    for (int e = 0; e < HR; ++e)
      if (hrow[e] < nb) hsums5_from(acc, e, smem + hrow[e] * ss + hx[e], bh * ss, n);
"""
HSUMS_DEF = "// Vertical pass, taps t0 .. t0 + n - 1 of every output:"
HSUMS5_DEF = """template <int HR_>
__device__ __forceinline__ void hsums5_from(float (&s)[5][HR_][4], int e, const float* p, int stride, int n) {
  float a[5][4], b[5][4];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    ld4(a[c], p + c * stride);
    ld4(b[c], p + c * stride + 4);
  }
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[c][e][i] += a[c][i];
  int t = n - 1;
  p += 8;
  for (; t >= 8; t -= 8, p += 8) {
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      htaps<4>(s[c][e], a[c], b[c]);
      ld4(a[c], p + c * stride);
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      htaps<4>(s[c][e], b[c], a[c]);
      ld4(b[c], p + c * stride + 4);
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    if (t >= 4) {
      htaps<4>(s[c][e], a[c], b[c]);
      ld4(a[c], p + c * stride);
      if (t == 7) htaps<3>(s[c][e], b[c], a[c]);
      else if (t == 6) htaps<2>(s[c][e], b[c], a[c]);
      else if (t == 5) htaps<1>(s[c][e], b[c], a[c]);
    } else if (t == 3) {
      htaps<3>(s[c][e], a[c], b[c]);
    } else if (t == 2) {
      htaps<2>(s[c][e], a[c], b[c]);
    } else if (t == 1) {
      htaps<1>(s[c][e], a[c], b[c]);
    }
  }
}

"""
# name -> (substitutions, plan keywords)
VARIANTS = {
    "wide": ([], {}),
    "th8": ([(VTH16, "constexpr int VTH = 8; ")], {"th": 8}),
    "span64": ([(VRS128, "constexpr int VRS = 64; ")], {"span": 64}),
    "span256": ([(VRS128, "constexpr int VRS = 256; ")], {"span": 256}),
    "runs256": ([(HR2, "constexpr int HR = 1; ")], {"runs": 256}),
    "hblocks2": ([(HBOUNDS, HBOUNDS.replace("3)", "2)"))], {}),
    "hblocks4": ([(HBOUNDS, HBOUNDS.replace("3)", "4)"))], {}),
    "chunk2": ([], {"chunks": 2}),
    "planes5": ([(HR2, "constexpr int HR = 1; "), (HSUMS_CALL, HSUMS5_CALL), (HSUMS_DEF, HSUMS5_DEF + HSUMS_DEF)],
                {"runs": 256}),
}
BUILT = {name: name for name in VARIANTS if VARIANTS[name][0]} | {"wide": "wide"}


def build(sources: dict) -> tuple[dict, dict]:
    """(name -> its ctypes library, name -> ptxas' lines for its wide-route
    kernels), every source built at once."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
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
            elif fn and re.search(r"box_(vsum|hsum_solve|rows|cols_solve)", fn) and (
                    "Used" in line or "spill" in line):
                text = line.split(":", 1)[-1].strip()
                regs.setdefault(name, []).append(f"{fn}: {text}")
                print(f"  {name} {fn}: {text}")
        libs[name] = ctypes.CDLL(os.path.join(OUT_DIR, f"lib{name}.so"))
    return libs, regs


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def runner(libs: dict, name: str, ws: int):
    """(m -> flow by variant ``name`` at winsize ``ws``, kernel launches a
    call); None where the variant cannot take the window."""
    def check(err):
        if err:
            raise RuntimeError(f"{name} winsize {ws}: CUDA error {err}")

    if name == "strip15":
        lib = libs["wide"]
        lib.relax_box_blur_solve.argtypes = _native._SIGNATURES["relax_box_blur_solve"]

        def run(m):
            p, _, h, w = m.shape
            flow = m.new_empty((p, 2, h, w))
            check(lib.relax_box_blur_solve(m.data_ptr(), flow.data_ptr(), p, h, w, 15, stream()))
            return flow
        return run, 1
    if name == "ring":
        if ws // 2 > 32:
            return None
        lib = libs["wide"]
        lib.relax_box_blur_solve_generic.argtypes = _native._SIGNATURES["relax_box_blur_solve_generic"]
        lib.relax_box_blur_solve_generic_slots.argtypes = [ctypes.c_int]
        slots = lib.relax_box_blur_solve_generic_slots(ws)

        def run(m):
            p, _, h, w = m.shape
            tw, seg, _ = _ring_plan(p, h, w, ws, slots)
            flow = m.new_empty((p, 2, h, w))
            check(lib.relax_box_blur_solve_generic(m.data_ptr(), flow.data_ptr(), p, h, w, ws, tw, seg, stream()))
            return flow
        return run, 1
    if name == "parent" and not hasattr(libs["parent"], "relax_box_blur_solve_wide_slots"):
        lib = libs["parent"]
        lib.relax_box_blur_solve_wide.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

        def run(m):
            p, _, h, w = m.shape
            flow, scratch = m.new_empty((p, 2, h, w)), torch.empty_like(m)
            check(lib.relax_box_blur_solve_wide(m.data_ptr(), scratch.data_ptr(), flow.data_ptr(), p, h, w, ws,
                                                stream()))
            return flow
        return run, 2
    lib = libs[BUILT.get(name, "wide") if name != "parent" else "parent"]
    lib.relax_box_blur_solve_wide.argtypes = _native._SIGNATURES["relax_box_blur_solve_wide"]
    lib.relax_box_blur_solve_wide_slots.argtypes = [ctypes.c_int]
    kw = dict(VARIANTS.get(name, ([], {}))[1])
    chunks = kw.pop("chunks", 1)
    nv = _wide_taps(ws, kw.get("th", 16), kw.get("span", 128))
    if chunks > 1:
        nv = kw["vtaps"] = -(-ws // chunks)
    slots = lib.relax_box_blur_solve_wide_slots(nv)
    if slots <= 0:
        raise RuntimeError(f"{name} winsize {ws}: slots query gave {slots}")

    def run(m):
        p, _, h, w = m.shape
        plan = _wide_plan(p, h, w, ws, slots, **kw)
        flow, scratch = m.new_empty((p, 2, h, w)), m.new_empty((p, 5, h, plan[0]))
        check(lib.relax_box_blur_solve_wide(m.data_ptr(), scratch.data_ptr(), flow.data_ptr(), p, h, w, ws, *plan,
                                            stream()))
        return flow
    return run, 1 + -(-ws // nv)


def device_ms(fns: list, launches: int, passes: int = 10, tries: int = 3) -> tuple[float | None, dict, list, int]:
    """(device ms a pass over ``fns``, ms a pass by kernel function, ms of
    each call, records kept).  Each call is profiled on its own, ``passes``
    times; a call whose records are not passes x ``launches`` (the profiler
    drops records now and then) is profiled again, ``tries`` times in all;
    then the ms is None."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total, split, calls, kept = 0.0, {}, [], 0
    for fn in fns:
        for _ in range(tries):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(passes):
                    fn()
                torch.cuda.synchronize()
            recs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(recs) == passes * launches:
                break
        else:
            return None, split, calls, kept
        for name, us in recs:
            short = (re.findall(r"box_\w+", name) or [name[:40]])[0]
            split[short] = split.get(short, 0.0) + us / passes / 1e3
        calls.append(sum(us for _, us in recs) / passes / 1e3)
        total += calls[-1]
        kept += len(recs)
    return total, split, calls, kept


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--variants", default=",".join([*VARIANTS, "ring", "strip15"]))
    ap.add_argument("--windows", default="63,65,67,101,131")
    ap.add_argument("--rounds", type=int, default=3, help="turns over the variants at each window")
    ap.add_argument("--parent", default=None, help="another boxsolve.cu whose wide pair to time as 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",") + (["parent"] if args.parent else [])
    windows = [int(x) for x in args.windows.split(",")]
    src = open(os.path.join(CSRC, "boxsolve.cu")).read()
    sources = {BUILT[n]: substitute(src, VARIANTS[n][0]) for n in names if n in BUILT} | {"wide": src}
    if args.parent:
        sources["parent"] = open(args.parent).read()
    libs, regs = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    levels = [torch.randn((PAIRS, 5, h, w), generator=gen, device="cuda") * 50 for _, h, w in pyramid_levels(H, W)]
    out = {}
    for ws in windows:
        rec = out[ws] = {}
        runs = {n: runner(libs, n, ws) for n in names}
        runs = {n: f for n, f in runs.items() if f is not None}
        for name, (run, _) in runs.items():
            if name == "strip15":
                rec[name] = {"device_ms": [], "split": [], "levels": [], "ms": [], "records": []}
                continue
            edges = [(1, 1, 1), (1, 5, 3), (1, ws - 2, 127), (1, 1, 128), (1, 3, 129), (2, 37, 131)]
            err = 0.0
            for m in levels + [torch.randn((p, 5, h, w), generator=gen, device="cuda") * 50 for p, h, w in edges]:
                want = box_blur_solve_plain(m, ws)
                for at in (0, 1):
                    e = (run(nan_padded(m, at)) - want).abs().max().item()
                    if not e == 0:
                        raise SystemExit(f"{name} winsize {ws} {tuple(m.shape)} offset {at}: |kernel - plain| {e}")
                    err = max(err, e)
            rec[name] = {"max_abs_err": err, "device_ms": [], "split": [], "levels": [], "ms": [], "records": []}
            print(f"  winsize {ws} {name}: largest |kernel - plain| {err} (540p levels, ragged shapes, aligned and "
                  f"offset by one float)")
        for _ in range(args.rounds):
            for name, (run, launches) in runs.items():
                fns = [lambda m=m, run=run: run(m) for m in levels]
                ms, split, by_level, n = device_ms(fns, launches)
                rec[name]["device_ms"].append(ms)
                rec[name]["split"].append(split)
                rec[name]["levels"].append(by_level)
                rec[name]["records"].append(n)
                rec[name]["ms"].append(event_ms(fns))
        for name, r in rec.items():
            launches = runs[name][1]
            split = {k: round(v, 4) for k, v in r["split"][-1].items()} if r["split"] else {}
            print(f"  winsize {ws} {name}: device ms a pass of 4 levels "
                  f"{[x if x is None else round(x, 4) for x in r['device_ms']]} (records {r['records']} of "
                  f"{10 * len(levels) * launches} launched; last turn by function {split}, by level "
                  f"{[round(x, 4) for x in r['levels'][-1]]}), ms by events {[round(x, 4) for x in r['ms']]}")
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

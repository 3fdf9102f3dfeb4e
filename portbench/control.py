"""The readings that the limits of ``correct`` are set from, for one cell:

- lower: the program's answers over one pass of the cell's pool, through
  the window's own loop, against the plain reference;
- upper: the control, the reference computed in the precision below the
  one the configuration states (``control_precision``: TF32 for strict f32,
  float8 for bf16), put in the program's place and held to the same numbers.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--out file.jsonl]

One JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import check, clips, harness, spec  # noqa: E402
from portbench.reference import to_served  # noqa: E402


def readings(cell: spec.Cell, seed: int, device: str = "cuda") -> dict:
    import gc

    import torch

    t = time.perf_counter()
    fx, pred, states = harness.build_program(cell, seed, device)
    pool = clips.pool(cell.traffic, seed, device)
    answers = harness.Loop(fx, pred, pool, cell.traffic["in_flight"]).run(videos=len(pool))
    del fx, pred
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    refs = harness.reference_answers(cell, states, pool, device)
    ctrl = harness.reference_answers(cell, states, pool, device, cell.config["control_precision"])
    vt = cell.traffic["video_type"]
    ctrl_answers = [(c, v, to_served(f(v), vt)) for c, (v, _, f) in ctrl.items()]
    lower = check.worst(((a.clip, a.vec, a.mos) for a in answers), refs, vt)
    upper = check.worst(ctrl_answers, refs, vt)
    per_clip = {a.clip: check.gaps(a.vec, a.mos, refs[a.clip], vt) for a in answers}
    per_clip_ctrl = {c: check.gaps(v, m, refs[c], vt) for c, v, m in ctrl_answers}
    rms = {k: float(sum((refs[c][0][sl].astype("float64") ** 2).mean() ** 0.5 for c in refs) / len(refs))
           for k, sl in check.PARTS.items()}
    swaps = [len(refs[c][1]) for c in sorted(refs)]
    return {"cell": cell.name, "seed": seed, "lower": lower, "control": upper,
            "pred100": [refs[c][2](refs[c][0]) for c in sorted(refs)], "ref_rms": rms, "pairs_with_swaps": swaps,
            "per_clip": {k: [per_clip[c][k] for c in sorted(per_clip)] for k in check.NUMBERS},
            "per_clip_control": {k: [per_clip_ctrl[c][k] for c in sorted(per_clip_ctrl)] for k in check.NUMBERS},
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    harness.require_cards(cell.chips)
    harness.pin_caches(spec.ROOT)
    for seed in args.seeds:
        line = json.dumps(readings(cell, seed))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

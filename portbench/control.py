"""The readings that the limits of ``correct`` are set from, for one cell:

- lower: the program's answers over one pass of the cell's pool, through
  the window's own loop, against the plain reference;
- upper: the control, the reference computed in the precision below the
  one the configuration states (``control_precision``), put in the
  program's place and held to the same numbers.

The program, the references and the numbers are the configuration's
family's (``families/<name>.py``).

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


def readings(cell: spec.Cell, seed: int, device: str = "cuda") -> dict:
    import gc

    import torch

    t = time.perf_counter()
    family = cell.family
    program, states = family.build(cell, seed, device)
    pool = clips.pool(cell.traffic, family.sample(cell.traffic), seed, device)
    answers = harness.Loop(program, pool, cell.traffic["in_flight"]).run(videos=len(pool))
    del program
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    refs = family.references(cell, states, pool, device)
    ctrl = family.references(cell, states, pool, device, cell.config["control_precision"])
    ctrl_answers = [(c, *family.served(cell, r)) for c, r in ctrl.items()]
    lower = check.worst(cell, ((a.clip, a.vec, a.mos) for a in answers), refs)
    upper = check.worst(cell, ctrl_answers, refs)
    per_clip = {a.clip: family.gaps(cell, a.vec, a.mos, refs[a.clip]) for a in answers}
    per_clip_ctrl = {c: family.gaps(cell, v, m, refs[c]) for c, v, m in ctrl_answers}
    names = cell.config["limits"]
    return {"cell": cell.name, "seed": seed, "lower": lower, "control": upper, **family.notes(cell, refs),
            "per_clip": {k: [per_clip[c][k] for c in sorted(per_clip)] for k in names},
            "per_clip_control": {k: [per_clip_ctrl[c][k] for c in sorted(per_clip_ctrl)] for k in names},
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

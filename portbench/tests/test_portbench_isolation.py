"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: ``relaxtpu_torch`` is the port, ``relaxtpu`` is not), and the
reference loads nothing of the port."""

import json
import subprocess
import sys

from .helpers import ROOT

BANNED = ("jax", "jaxlib", "flax", "relaxtpu")

_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests.helpers import tiny_cell, tiny_run
res = tiny_run(tiny_cell(), seconds=0.3)
print(json.dumps([res["correct"], sorted({{m.split(".")[0] for m in sys.modules}})]))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from portbench import clips, weights
from portbench.reference import Reference
from portbench.tests.helpers import tiny_cell
cell = tiny_cell()
rn, vit = weights.backbones(1, 2, torch.float32, "cpu")
head = weights.head(1, 35203, "cpu", 50.0, 10.0)
pool = clips.pool(cell.traffic, cell.family.sample(cell.traffic), 1, "cpu")
ref = Reference(rn, vit, head, weights.scaler(1, np.ones(35203), 0.5, 0.1), 2, "konvid_1k", "cpu")
v, swaps = ref.answer(pool[0].groups["frames"], pool[0].groups["nexts"], 64, 64)
print(json.dumps([bool(np.isfinite(v).all()), ref.pred100(v), sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def _tops(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    correct, tops = _tops(_RUN)
    assert correct is True
    assert "relaxtpu_torch" in tops
    assert not set(tops) & set(BANNED), tops


def test_reference_loads_nothing_of_the_port():
    finite, mos, tops = _tops(_REFERENCE)
    assert finite
    assert not set(tops) & set(BANNED + ("relaxtpu_torch",)), tops

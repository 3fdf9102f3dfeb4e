"""The control on the card: the reference computed one precision below the
configuration's (TF32 for strict f32, float8 for bf16) and put in the
program's place fails the check, while the program passes it, at the cells'
own sizes with a pool of two clips.

    python3 -m pytest portbench/tests -m card
"""

import pytest

from portbench import check, control, spec


@pytest.mark.card
@pytest.mark.parametrize("name", ["bf16-konvid540-stream", "f32-konvid540-stream", "bf16-qualcomm1080-stream"])
def test_control_fails_and_program_passes(card, name):
    cell = spec.resolve(name)
    cell.traffic = dict(cell.traffic, pool=2)
    r = control.readings(cell, 2**31 + 11, "cuda")
    limits = cell.config["limits"]
    assert check.judge(r["lower"], limits)[0], r["lower"]
    assert not check.judge(r["control"], limits)[0], r["control"]

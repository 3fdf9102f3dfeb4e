"""MOS scale maps between 1-5 and 1-100 (own copy of
``relaxtpu/data/mos.py:14-23``).

- training / cross-dataset map: mos100 = (mos5 - 1) * (99/4) + 1
- demo prediction rescale: pred5 = pred100 / 100 * 4 + 1
"""

from __future__ import annotations

import numpy as np


def mos_1_5_to_1_100(mos):
    return (np.asarray(mos, dtype=float) - 1.0) * (99.0 / 4.0) + 1.0


def mos_1_100_to_1_5(mos):
    return (np.asarray(mos, dtype=float) - 1.0) / (99.0 / 4.0) + 1.0


def pred_0_100_to_1_5(pred):
    return np.asarray(pred, dtype=float) / 100.0 * 4.0 + 1.0

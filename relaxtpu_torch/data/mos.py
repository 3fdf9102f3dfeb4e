"""MOS rescale of the demo prediction (own copy of
``relaxtpu/data/mos.py:22-23``): pred5 = pred100 / 100 * 4 + 1.

The training maps of that module wait for the training slice.
"""

from __future__ import annotations

import numpy as np


def pred_0_100_to_1_5(pred):
    return np.asarray(pred, dtype=float) / 100.0 * 4.0 + 1.0

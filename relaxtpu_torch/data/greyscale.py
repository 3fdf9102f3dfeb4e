"""Greyscale rows to drop before a split (own copy of
``relaxtpu/data/greyscale.py:64-74``, read with the ``csv`` module).

The report writer (``greyscale_report``) needs cv2 and is not ported yet.
"""

from __future__ import annotations

import csv
import os


def load_grey_indices(report_csv: str) -> list[int]:
    """Metadata row indices from the first column of a greyscale report
    CSV (header ``Index,vid,Is Greyscale``); [] when the file is absent."""
    if not os.path.exists(report_csv):
        return []
    with open(report_csv, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return [int(r[0]) for r in rows if r]

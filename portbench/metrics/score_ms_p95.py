"""score_ms_p95: the 95th percentile, over every request of the window, of
the host milliseconds from the enqueue's start to the MOS (a failed request
counts as never answered)."""
import math

import numpy as np


def read(ctx):
    lat = [(a.t_done - a.t_enqueue) * 1e3 if a.vec is not None else math.inf for a in ctx.answers]
    return float(np.percentile(lat, 95)) if lat else None

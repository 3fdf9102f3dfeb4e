"""score_ms_p50: the median, over every request of the window, of the host
milliseconds from the enqueue's start to the MOS."""
import numpy as np


def read(ctx):
    lat = [(a.t_done - a.t_enqueue) * 1e3 for a in ctx.answers]
    return float(np.percentile(lat, 50)) if lat else None

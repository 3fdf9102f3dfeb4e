"""launches_per_video: device operations (kernels, copies, sets) launched
inside the program's ``relaxtpu.enqueue`` spans, a stretch video; records
the profiler dropped are not counted (``portbench/spans.py`` prints them)."""

from portbench import spans


def read(ctx):
    return spans.launches_per_video(ctx)

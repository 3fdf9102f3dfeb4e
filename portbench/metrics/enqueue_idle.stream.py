"""enqueue_idle: the share (%) of the profiled stretch in which no device
operation ran while the host was inside a ``relaxtpu.enqueue`` span: the
device waiting on the program's staging and launches.  The rest of
``device_idle`` is idle time outside the program's enqueue
(``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.enqueue_idle(ctx)

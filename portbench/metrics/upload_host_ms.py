"""upload_host_ms: host milliseconds a stretch video inside the program's
``relaxtpu.upload`` spans: the staging of the host I420 into pinned memory
and the call of the copy (``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "upload")

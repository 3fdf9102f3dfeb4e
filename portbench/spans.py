"""The program's own spans in a traced stretch.

The serving programs (``relaxtpu_torch/features/pipeline.py``) open
``relaxtpu.<stage>`` profiler ranges while the profiler records: one
``relaxtpu.enqueue`` a program call, holding ``upload``, ``colorspace``,
``fragments`` (holding ``flow``), ``prep``, ``resnet``, ``vit`` and
``aggregate``.  They are host events of the profiler, on the clock of its
device records, so each device operation is put down to the innermost
span that held its launch on the host (self attribution: an operation
launched inside ``relaxtpu.flow`` counts for the flow, not for
``fragments`` or ``enqueue``), and each idle stretch of the device to the
innermost span the host was in, or to no span ("outside").

``summary(ctx)`` reduces the stretch once a run and prints the reduction
to standard error; the readers of ``metrics/`` take their numbers from it.
A program without the spans (an older commit) gives None, and its readers
say nothing.
"""

from __future__ import annotations

import dataclasses
import sys

PREFIX = "relaxtpu."
ROOT = "enqueue"
STAGES = ("upload", "colorspace", "fragments", "flow", "prep", "resnet", "vit", "aggregate")
OUTSIDE = "outside"
# host runtime calls that put one operation on the device (kernel, copy, set)
_LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")


@dataclasses.dataclass
class Spans:
    videos: int  # the divisor: ctx.stretch_videos
    enqueues: int  # relaxtpu.enqueue ranges that start in the stretch
    seen: set  # span names (without the prefix) found in the stretch
    has_ops: bool  # the trace holds device operations
    device_ms: dict  # innermost span -> device ms a video of the operations launched in it
    launches: dict  # innermost span -> device operations a video launched in it
    host_ms: dict  # span -> host ms a video inside it
    host_self_ms: dict  # span -> the same less its child spans
    in_enqueue_launches: int  # device operations launched inside relaxtpu.enqueue (any depth)
    in_enqueue_calls: int  # host launch, copy and set calls inside relaxtpu.enqueue
    dropped: list  # (name, ms before the stretch's end) of those calls whose device record is missing
    idle_s: dict  # innermost span the host was in, or OUTSIDE -> idle device seconds in the stretch
    enqueue_idle_s: float  # idle device seconds while the host was inside relaxtpu.enqueue
    window_s: float

    def coverage(self) -> float | None:
        """The eight stages' share of the device ms launched inside relaxtpu.enqueue."""
        total = sum(v for k, v in self.device_ms.items() if k in STAGES or k == ROOT)
        return sum(self.device_ms.get(k, 0.0) for k in STAGES) / total if total > 0 else None


def _innermost(ranges: list, times: list) -> list:
    """Index into ``ranges`` ((start, end, name), properly nested, sorted by
    start and then by longest) of the innermost range that holds each of
    the sorted ``times``, or -1."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and ranges[stack[-1]][1] < ranges[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _segments(ranges: list, t0: int, t1: int) -> list:
    """[t0, t1] cut at every range boundary: (start, end, index of the
    innermost range, or -1) for each piece."""
    cuts = sorted({t0, t1, *(t for s, e, _ in ranges for t in (s, e) if t0 < t < t1)})
    pieces = list(zip(cuts[:-1], cuts[1:]))
    owners = _innermost(ranges, [(a + b) / 2 for a, b in pieces])
    return [(a, b, k) for (a, b), k in zip(pieces, owners)]


def _overlap(gaps: list, segments: list) -> list:
    """Seconds of the sorted disjoint ``gaps`` that fall in each of the
    sorted disjoint ``segments``."""
    out, j = [0] * len(segments), 0
    for s, e in gaps:
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            out[k] += min(e, segments[k][1]) - max(s, segments[k][0])
            k += 1
    return [v / 1e9 for v in out]


def reduce(trace, videos: int) -> Spans | None:
    """The stretch's spans (those that start in it) -> :class:`Spans`, a
    video being one of ``videos``; None where the stretch has no span."""
    ranges = sorted(((s, e, name[len(PREFIX):]) for s, e, name in trace.host
                     if name.startswith(PREFIX) and trace.t0 <= s <= trace.t1), key=lambda r: (r[0], -r[1]))
    if not ranges or not videos:
        return None
    roots = [r for r in ranges if r[2] == ROOT]
    ops = sorted((op for op in trace.ops if op.launched is not None), key=lambda op: op.launched)
    launched = [op.launched for op in ops]

    device_ns, launches = {}, {}
    for op, k in zip(ops, _innermost(ranges, launched)):
        if k >= 0:
            name = ranges[k][2]
            device_ns[name] = device_ns.get(name, 0) + (op.end - op.start)
            launches[name] = launches.get(name, 0) + 1
    in_enqueue = sum(k >= 0 for k in _innermost(roots, launched))
    calls = sorted((s, name) for s, _, name in trace.host
                   if name.startswith(("cuda", "cu")) and any(c in name for c in _LAUNCH_CALLS))
    calls = [c for c, k in zip(calls, _innermost(roots, [s for s, _ in calls])) if k >= 0]
    recorded = set(launched)
    dropped = [(name, (trace.t1 - s) / 1e6) for s, name in calls if s not in recorded]

    host_ns, self_ns, stack = {}, {}, []
    for s, e, name in ranges:
        while stack and stack[-1][1] < s:
            stack.pop()
        host_ns[name] = host_ns.get(name, 0) + (e - s)
        self_ns[name] = self_ns.get(name, 0) + (e - s)
        if stack:
            self_ns[stack[-1][2]] -= e - s
        stack.append((s, e, name))

    gaps = trace.gaps()
    segments = _segments(ranges, trace.t0, trace.t1)
    idle_s: dict = {}
    for (_, _, k), sec in zip(segments, _overlap(gaps, segments)):
        if sec > 0:
            name = ranges[k][2] if k >= 0 else OUTSIDE
            idle_s[name] = idle_s.get(name, 0.0) + sec
    root_segments = _segments(roots, trace.t0, trace.t1)
    enqueue_idle_s = sum(sec for (_, _, k), sec in zip(root_segments, _overlap(gaps, root_segments)) if k >= 0)

    per = 1e6 * videos  # ns -> ms a video
    return Spans(videos=videos, enqueues=len(roots), seen={r[2] for r in ranges}, has_ops=bool(trace.ops),
                 device_ms={k: v / per for k, v in device_ns.items()},
                 launches={k: v / videos for k, v in launches.items()},
                 host_ms={k: v / per for k, v in host_ns.items()},
                 host_self_ms={k: v / per for k, v in self_ns.items()},
                 in_enqueue_launches=in_enqueue, in_enqueue_calls=len(calls), dropped=dropped,
                 idle_s=idle_s, enqueue_idle_s=enqueue_idle_s, window_s=trace.window_s)


def report(sp: Spans) -> None:
    def say(line: str) -> None:
        print(f"portbench spans: {line}", file=sys.stderr)

    say(f"{sp.enqueues} relaxtpu.enqueue ranges in the stretch, {sp.videos} stretch videos"
        + ("" if sp.enqueues == sp.videos else " (MISMATCH)"))
    if not sp.has_ops:  # no device in the trace: the host's figures alone
        say("span: host ms, host self ms; a video")
        for name in (ROOT, *STAGES):
            if name in sp.seen:
                say(f"  {name}: {sp.host_ms[name]:.4f}, {sp.host_self_ms[name]:.4f}")
        return
    say("span: device ms, host ms, host self ms, launches; a video (enqueue: what no stage holds)")
    for name in (ROOT, *STAGES):
        if name in sp.seen:
            say(f"  {name}: {sp.device_ms.get(name, 0.0):.4f}, {sp.host_ms[name]:.4f}, "
                f"{sp.host_self_ms[name]:.4f}, {sp.launches.get(name, 0.0):.2f}")
    cov = sp.coverage()
    if cov is not None:
        say(f"the eight stages hold {100 * cov:.3f}% of the device ms launched inside relaxtpu.enqueue")
    say(f"inside relaxtpu.enqueue: {sp.in_enqueue_calls} host launch/copy/set calls, {sp.in_enqueue_launches} "
        f"device records; {len(sp.dropped)} calls without a record (dropped)"
        + "".join(f"; {name} {ms:.3f} ms before the stretch's end" for name, ms in sp.dropped[:5]))
    idle = ", ".join(f"{k} {1e3 * v:.3f} ms ({100 * v / sp.window_s:.3f}%)"
                     for k, v in sorted(sp.idle_s.items(), key=lambda kv: -kv[1]))
    say(f"device idle by the host's innermost span: {idle}")
    say(f"device idle inside relaxtpu.enqueue {1e3 * sp.enqueue_idle_s:.3f} ms "
        f"({100 * sp.enqueue_idle_s / sp.window_s:.3f}% of the stretch)")


_last: list = [None, None]  # (trace, Spans or None) of the last run reduced: one report a run


def summary(ctx) -> Spans | None:
    """The run's :class:`Spans` (reduced and reported once a trace), or None
    without a trace or without spans."""
    if ctx.trace is None:
        return None
    if _last[0] is not ctx.trace:
        sp = reduce(ctx.trace, ctx.stretch_videos)
        t = ctx.trace
        enq = [e - s for s, e in t.ranges.get("portbench.enqueue", []) if t.t0 <= s <= t.t1]
        if enq and ctx.stretch_videos:  # on any program, for the spans' cost against one without them
            print(f"portbench spans: traced stretch {1e3 * t.window_s / ctx.stretch_videos:.3f} ms a video, "
                  f"portbench.enqueue {sum(enq) / len(enq) / 1e6:.3f} host ms a video", file=sys.stderr)
        if sp is None:
            print("portbench spans: no relaxtpu.* span in the stretch", file=sys.stderr)
        else:
            report(sp)
        _last[:] = [ctx.trace, sp]
    return _last[1]


def stage_device_ms(ctx, stage: str):
    sp = summary(ctx)
    if sp is None or not sp.has_ops or stage not in sp.seen:
        return None
    return sp.device_ms.get(stage, 0.0)


def launches_per_video(ctx):
    sp = summary(ctx)
    if sp is None or not sp.has_ops:
        return None
    return sp.in_enqueue_launches / sp.videos


def host_ms(ctx, stage: str):
    sp = summary(ctx)
    if sp is None or stage not in sp.seen:
        return None
    return sp.host_ms[stage]


def enqueue_idle(ctx):
    sp = summary(ctx)
    if sp is None or not sp.has_ops or sp.window_s <= 0:
        return None
    return 100.0 * sp.enqueue_idle_s / sp.window_s

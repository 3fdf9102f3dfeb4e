"""The traced run's instruments and the reduction of its device trace.

``--trace 1`` installs named host ranges around calls into the program's
layers (all ``portbench.*``): the enqueue and the fetch of each video, and,
as the cell's per-layer metrics declare them (``Instruments``), numbered
ranges around calls of the program's functions (a flow, a kernel's wrapper)
and the forwards of its networks (hooks), so that every kernel record the
profiler keeps is paired with the work of its own call.  The
profiler runs over a stretch of whole videos inside the window, in memory.

The reduction reads the profiler's raw events once: device operations
(kernels, copies, sets) with their launch's host time (by correlation id),
and the host ranges.  A device operation belongs to a range when the
runtime call that launched it lies inside the range on the host.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time

import torch

_LAUNCH_PREFIXES = ("cuda", "cu")  # runtime and driver calls that launch or copy


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    launched: int | None  # host ns of the runtime call that launched it


@dataclasses.dataclass
class Trace:
    ops: list  # DeviceOp, by start
    ranges: dict  # name -> [(start, end)] host ns
    host: list  # (start, end, name) of every host event, by start
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran, inside the window."""
        busy, cur_s, cur_e = 0, None, None
        for op in self.ops:
            s, e = max(op.start, self.t0), min(op.end, self.t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def gaps(self) -> list:
        """(start, end) ns of the stretches of the window with no device operation."""
        out, t = [], self.t0
        for op in self.ops:
            if op.start > t:
                out.append((t, min(op.start, self.t1)))
            t = max(t, op.end)
            if t >= self.t1:
                break
        if t < self.t1:
            out.append((t, self.t1))
        return [(s, e) for s, e in out if e > s]

    def ops_in(self, prefix: str) -> dict:
        """Device operations launched inside each range whose name starts
        with ``prefix`` (ranges of one prefix do not overlap): {range name:
        [DeviceOp]}; ranges whose operations were all dropped are left out."""
        spans = sorted((s, e, name) for name, lst in self.ranges.items() if name.startswith(prefix) for s, e in lst)
        starts = [s for s, _, _ in spans]
        out: dict = {}
        for op in self.ops:
            i = bisect.bisect_right(starts, op.launched) - 1 if op.launched is not None else -1
            if i >= 0 and op.launched <= spans[i][1]:
                out.setdefault(spans[i][2], []).append(op)
        return out

    def device_s_in(self, prefix: str) -> float:
        return sum((op.end - op.start) for ops in self.ops_in(prefix).values() for op in ops) / 1e9

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the outermost benchmark range
        inside the stretch and the innermost other host event that hold it."""
        outer, inner = None, None
        for s, e, name in self.host:
            if s > t:
                break
            if e >= t and name != "portbench.stretch":
                if name.startswith("portbench.") and outer is None:
                    outer = name
                if not name.startswith("portbench.") and (inner is None or e - s < inner[1] - inner[0]):
                    inner = (s, e, name)
        parts = [p for p in (outer, inner[2] if inner else None) if p]
        return " > ".join(parts) if parts else "host idle"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0) + (op.end - op.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
                "idle_gaps": [[self.host_at(s), (e - s) / 1e9] for s, e in gaps]}


def reduce(prof, window_range: str = "portbench.stretch") -> Trace:
    """The profiler's raw events -> a :class:`Trace` whose window is the
    host's ``window_range`` range (work still running when it closes, which
    the profiler's stop waits for, lies past the window)."""
    events = prof.profiler.kineto_results.events()
    launch, ranges, host, dev = {}, {}, [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
            continue
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        host.append((s, s + d, name))
        if name.startswith("portbench."):
            ranges.setdefault(name, []).append((s, s + d))
        elif name.startswith(_LAUNCH_PREFIXES) and e.correlation_id():
            launch[e.correlation_id()] = s
    ops = sorted((DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), launch.get(e.correlation_id()))
                  for e in dev), key=lambda o: o.start)
    host.sort()
    (t0, t1), = ranges[window_range]
    unmatched = sum(op.launched is None for op in ops)
    print(f"portbench trace: {len(ops)} device operations, {unmatched} without a launch on the host, "
          f"{len(host)} host events, window {(t1 - t0) / 1e9:.6f} s", file=sys.stderr)
    return Trace(ops, ranges, host, t0, t1)


class Instruments:
    """The traced run's ranges, declared by the per-layer metrics' files and
    removed by :meth:`remove`.  A metric file may name ``CALLS = (module,
    attribute)``, a function of the program as its caller looks it up, whose
    every call runs inside a range ``portbench.<metric>.<n>``, and
    ``bound_s(*args, **kwargs)``, the least seconds of that call; or ``HOOKS``,
    attributes of the program (networks, ``families/<name>.py``) whose every
    forward runs inside such a range."""

    def __init__(self, program, metrics: dict):
        import importlib

        self.calls = {}  # metric -> the bound (s, or None) of each call, by call number
        self._saved, self._hooks, self._open = [], [], {}
        for name, mod in metrics.items():
            if hasattr(mod, "CALLS"):
                target = importlib.import_module(mod.CALLS[0])
                fn = getattr(target, mod.CALLS[1])
                self._saved.append((target, mod.CALLS[1], fn))
                setattr(target, mod.CALLS[1], self._ranged(name, fn, getattr(mod, "bound_s", None)))
            for attr in getattr(mod, "HOOKS", ()):
                net = getattr(program, attr)
                self._hooks.append(net.register_forward_pre_hook(self._enter(name)))
                self._hooks.append(net.register_forward_hook(self._exit(name)))

    def _ranged(self, name, fn, bound):
        calls = self.calls.setdefault(name, [])

        def call(*a, **kw):
            calls.append(bound(*a, **kw) if bound else None)
            with torch.profiler.record_function(f"portbench.{name}.{len(calls) - 1}"):
                return fn(*a, **kw)
        return call

    def _enter(self, name):
        calls = self.calls.setdefault(name, [])

        def hook(module, args):
            calls.append(None)
            rf = torch.profiler.record_function(f"portbench.{name}.{len(calls) - 1}")
            rf.__enter__()
            self._open[(name, id(module))] = rf
        return hook

    def _exit(self, name):
        def hook(module, args, out):
            self._open.pop((name, id(module))).__exit__(None, None, None)
        return hook

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)


def profiler():
    """A CPU and CUDA profiler, kept in memory."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def warm_profiler() -> float:
    """Start and stop the profiler once over a tiny launch, so that the
    tracing library's set-up falls into set-up -> its seconds."""
    t = time.perf_counter()
    with profiler():
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t

"""One run of one cell: set-up, the timed window, the check, the result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that knows the model is the configuration's family's
(``families/<name>.py``, ``spec.family_module``); this file knows none.
Set-up (counted in ``setup_s``, from the process's start): imports, CUDA,
the family's program (``build``: kernels, seeded weights on the card), the
clip pool on the host (the frames of each clip that the family's ``sample``
names), and a warm-up through the window's own loop on the pool's first
clips.  The window drives the program closed-loop: its ``enqueue`` of each
clip's host buffers, then its ``finish`` of the handle into the host vector
and the score, with ``in_flight`` videos enqueued ahead (0: one client that
waits for each score).  Enqueuing stops at the
deadline; the window closes when the last video enqueued is scored.

After the window: the peak device memory is read, the program is freed,
and the family's plain reference answers every clip of the pool; every
answer of the window is held against its clip's reference (``check``).  The
numbers compared and their limits are printed last on standard error and
last in the result line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import sys
import time

from . import check, clips, spec

BANNED = ("jax", "jaxlib", "flax", "relaxtpu")  # top-level module names, compared whole
CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH")


class NoCard(RuntimeError):
    pass


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def require_cards(chips: int) -> None:
    """Raise unless CUDA offers ``chips`` cards: the benchmark never runs on the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"this cell needs {chips} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def pin_caches(root: str) -> None:
    """Every kernel cache at a fixed directory inside the checkout."""
    for var in CACHE_VARS:
        os.environ[var] = os.path.join(root, "build", "portbench", var.lower())


@dataclasses.dataclass
class Answer:
    index: int
    clip: int
    t_enqueue: float
    t_enqueued: float
    t_done: float
    vec: object
    mos: float  # the score


@dataclasses.dataclass
class Context:
    """What the metric readers read (``metrics/<name>.py``: ``read(ctx)``)."""
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    answers: list
    trace: object = None  # trace.Trace of the profiled stretch, with --trace 1
    stretch_videos: int = 0
    calls: dict = dataclasses.field(default_factory=dict)  # instrumented metric -> each call's bound (s) or None
    enqueue_ms: list = dataclasses.field(default_factory=list)  # host ms of each enqueue outside the stretch
    video_flops: float = 0.0
    peak_flops: float = 0.0

    def device_ms_per_video(self, metric: str):
        """Device ms a stretch video of the work launched inside ``metric``'s ranges."""
        if self.trace is None or not self.stretch_videos:
            return None
        s = self.trace.device_s_in(f"portbench.{metric}.")
        return 1e3 * s / self.stretch_videos if s > 0 else None

    def roofline(self, metric: str, kernel: str):
        """100 x the bound of ``metric``'s calls whose records of ``kernel``
        the profiler kept, over those records' device time."""
        if self.trace is None:
            return None
        bound = device = 0.0
        for rng, ops in self.trace.ops_in(f"portbench.{metric}.").items():
            mine = [op for op in ops if kernel in op.name]
            if mine:
                bound += self.calls[metric][int(rng.rsplit(".", 1)[1])]
                device += sum(op.end - op.start for op in mine) / 1e9
        return 100.0 * bound / device if device > 0 else None


class Loop:
    """The closed loop over the pool: enqueue, keep ``in_flight`` ahead, fetch and score."""

    def __init__(self, program, pool: list, in_flight: int):
        self.program, self.pool, self.in_flight = program, pool, in_flight
        self.next_index = 0

    def _enqueue(self, ranged):
        i = self.next_index
        c = i % len(self.pool)
        clip = self.pool[c]
        self.next_index += 1
        t0 = time.perf_counter()
        try:
            with ranged("portbench.enqueue"):
                handle = self.program.enqueue(clip)
        except Exception as e:  # a failed request is counted, and the loop goes on
            log(f"portbench: request {i} failed at the enqueue: {e!r}")
            handle = None
        return i, c, t0, time.perf_counter(), handle

    def _finish(self, item, ranged) -> Answer:
        i, c, t0, t1, handle = item
        host, mos = None, math.nan
        if handle is not None:
            try:
                with ranged("portbench.fetch"):
                    host, mos = self.program.finish(handle)
            except Exception as e:
                log(f"portbench: request {i} failed at the fetch: {e!r}")
        return Answer(i, c, t0, t1, time.perf_counter(), host, mos)

    def run(self, deadline: float | None = None, videos: int | None = None, stretch=None) -> list:
        """Until ``deadline`` (host clock) or ``videos`` enqueued, and until
        ``stretch`` (a trace stretch, begun and ended at video boundaries)
        has closed; then drain."""
        from contextlib import nullcontext

        def more() -> bool:
            return (deadline is None or time.perf_counter() < deadline) and (videos is None or self.next_index < videos)

        ranged = stretch.ranged if stretch else (lambda name: nullcontext())
        pending, out = collections.deque(), []
        while more() or (stretch and stretch.state != "closed"):
            if stretch:
                stretch.at_boundary(len(out))
                if stretch.state == "closed" and not more():
                    break
            pending.append(self._enqueue(ranged))
            while len(pending) > self.in_flight:
                out.append(self._finish(pending.popleft(), ranged))
        while pending:
            out.append(self._finish(pending.popleft(), ranged))
        return out


class Stretch:
    """The profiled stretch: begun at the first video boundary at or after
    ``after`` (host clock), ended ``videos`` finished videos later, in memory;
    ``launch_counts`` (the family's) is read at both ends."""

    def __init__(self, after: float, videos: int, launch_counts):
        from . import trace

        self.trace_mod, self.after, self.videos, self.launch_counts = trace, after, videos, launch_counts
        self.prof = self.range = None
        self.begun_at = None  # finished videos when begun
        self.t_begin = self.t_end = None  # host clock
        self.state = "waiting"
        self.launches = {}

    def ranged(self, name):
        import torch

        return torch.profiler.record_function(name)

    def at_boundary(self, finished: int) -> None:
        if self.state == "waiting" and time.perf_counter() >= self.after:
            self.launches = self.launch_counts()
            self.prof = self.trace_mod.profiler()
            self.prof.start()
            self.range = self.ranged("portbench.stretch")
            self.range.__enter__()
            self.begun_at, self.state, self.t_begin = finished, "open", time.perf_counter()
        elif self.state == "open" and finished - self.begun_at >= self.videos:
            self.t_end = time.perf_counter()
            self.range.__exit__(None, None, None)
            self.prof.stop()
            after = self.launch_counts()
            self.launches = {k: after[k] - self.launches[k] for k in after}
            self.state = "closed"


def _number(v: float) -> float:
    return v if math.isfinite(v) else 1.0e308


def run(args, t_start: float, device: str = "cuda", cell: spec.Cell | None = None) -> dict:
    """One run -> the result line's object.  ``device`` and ``cell`` are for
    tests, which drive the rest of a run on the CPU."""
    import torch

    cell = cell or spec.resolve(args.workload)
    if device == "cuda":
        require_cards(cell.chips)
    pin_caches(spec.ROOT)
    cfg, traffic, family = cell.config, cell.traffic, cell.family
    program, states = family.build(cell, args.seed, device)
    pool = clips.pool(traffic, family.sample(traffic), args.seed, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    instruments = stretch = None
    if args.trace:
        from . import trace

        if device == "cuda":
            log(f"portbench: profiler warm-up {trace.warm_profiler():.3f} s")
        instruments = trace.Instruments(program, {m["name"]: spec.metric_module(m["name"]) for m in cell.per_layer})
    loop = Loop(program, pool, traffic["in_flight"])
    loop.run(videos=traffic["warmup_videos"])
    sync()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    if args.trace:
        stretch = Stretch(t0 + traffic["trace_after"] * args.seconds, traffic["trace_videos"], family.launch_counts)
    answers = loop.run(deadline=t0 + args.seconds, stretch=stretch)
    window_s = time.perf_counter() - t0
    sync()
    gc.unfreeze()
    if banned_modules():
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {banned_modules()}")
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0}
    ctx = Context(cfg, traffic, setup_s, window_s, answers,
                  video_flops=family.video_flops(cell, pool[0]), peak_flops=family.peak_flops(cell))
    breakdown = None
    if stretch is not None:
        if stretch.state != "closed":
            raise RuntimeError("the traced stretch did not close inside the run")
        ctx.trace = stretch.trace_mod.reduce(stretch.prof)
        ctx.calls = instruments.calls
        spans = ctx.trace.ranges.get("portbench.enqueue", [])
        ctx.stretch_videos = sum(ctx.trace.t0 <= s <= ctx.trace.t1 for s, _ in spans)
        ctx.enqueue_ms = [(a.t_enqueued - a.t_enqueue) * 1e3 for a in answers
                          if not stretch.t_begin <= a.t_enqueue <= stretch.t_end]
        log(f"portbench trace: the port's launch counters over the stretch {stretch.launches}")
        for name, calls in instruments.calls.items():
            ranges = [r for r, lst in ctx.trace.ranges.items() if r.startswith(f"portbench.{name}.")
                      for s, _ in lst if ctx.trace.t0 <= s <= ctx.trace.t1]
            kernel = getattr(spec.metric_module(name), "KERNEL", "")
            kept = sum(kernel in op.name for ops in ctx.trace.ops_in(f"portbench.{name}.").values() for op in ops)
            log(f"portbench trace: {name}: {len(ranges)} calls in the stretch, {kept} device records kept"
                + (f" of {kernel}" if kernel else ""))
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.window_s
        breakdown = ctx.trace.breakdown()
        instruments.remove()
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_module(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program freed, the reference on the card
    del program, loop, instruments
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refs = family.references(cell, states, pool, device)
    log(f"portbench: reference over {len(pool)} clips {time.perf_counter() - t:.3f} s; "
        f"{len(answers)} answers compared")
    failed = sum(a.vec is None for a in answers)
    ok, table = check.judge(check.worst(cell, ((a.clip, a.vec, a.mos) for a in answers if a.vec is not None), refs),
                            cfg["limits"])
    result = {"correct": bool(ok and answers and not failed), "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]} for k, v in table.items()}
    for k, v in table.items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        result = run(args, t_start)
    except NoCard as e:
        log(f"portbench: {e}")
        return 2
    bad = banned_modules()
    if bad:
        log(f"portbench: modules of JAX or the JAX package are loaded: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0

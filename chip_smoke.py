"""Smoke run of the PyTorch/CUDA port (``relaxtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``relaxtpu_torch/csrc`` and time the build;
   print each kernel function's registers and spills (ptxas) and the count
   of tensor-core instructions in each K3 function's SASS (cuobjdump),
   failing if a bf16 K3 function has none;
3. hold each kernel against its plain PyTorch version on the card: K1
   (matrix update) and K2 (box blur + solve) at the four 540p and the four
   1080p pyramid levels with 16 pairs, at the 4K finest level (2160x3840)
   with 4 pairs, with per-pixel random flows up to +-40 px, and at 16x20
   and 67x131; K2 also at winsize 5 and 17 (and at 1080x1920 with 2 pairs)
   and refusing 19; then the flow's live f32 planes a pair at 1080p
   (``max_memory_allocated`` around ``farneback_flow``, 16 pairs) must fit
   the pipeline's working-set model; K3
   (attention) at (48, 197, 12, 64) and at N in {1, 17, 64, 197, 208, 256}
   x D in {32, 64}, in f32 and bf16, contiguous and as packed-qkv slices;
   every input sits at the start of a NaN-filled allocation;
4. the 35,203 vector of a CUDA run against a CPU run (2 frames, 240x320,
   depth-2 ViT, f32 with TF32 off): per-segment cosine >= 0.99999;
5. the full-width main path: a seeded 540x960 raw I420 clip of 32 frames at
   4 fps (16 frames, 16 pairs) through ``VideoQualityPredictor.predict_file``
   with seeded ResNet-50, ViT-B/16 (depth 12) and MLP weights, in bf16 and
   in f32; K1, K2 and K3 must each launch 12 times per video, the MOS must
   be finite and the bf16 vector within cosine 0.9999 of the f32 one;
   then one more video records every kernel call's inputs, and each kernel,
   its plain version and (for K3) ``F.scaled_dot_product_attention`` are
   checked and timed on exactly those inputs, per video: CUDA events
   around repeated calls, and the profiler's device durations alone;
6. the serving paths, full width (ResNet-50, ViT-B/16 depth 12, seeded),
   in bf16 and f32, each run with the launch counts set to 0 before it and
   read after it:
   (a) four 540x960 clips at 4 fps of (16, 16), (16, 16), (14, 13) and
       (12, 12) frames and pairs through ``video_features_batch_i420``
       against each clip's single-video vector (per-segment cosine
       >= 0.99999 in f32, >= 0.9999 in bf16); K1 = K2 = 12 x
       ceil(57 / max_pair_batch) launches, K3 = 12; the backbones' peak
       memory over the 172 images must fit the working-set model;
   (b) the same clips through ``enqueue_file`` with 2 in flight against
       their single-video vectors;
   (c) a 1080x1920 clip of 20 frames and 20 pairs through
       ``video_feature_async_i420``, which takes the chunked path (K1 = K2
       = 12 x ceil(20 / chunk)), against the unchunked program (12);
   (d) the serve loop in-process: two clips and a bad line, answered in
       order, the MOS within 1e-5 of ``predict_file``'s;
   every enqueue of (a)-(c) runs under ``torch.cuda.set_sync_debug_mode
   ("error")``, so a hidden synchronisation fails the run; in bf16, warm
   ms per video (median of 3) one after the other, streamed and batched
   (the four clips, and the four clips three times over), and of the 1080p
   clip, each with the device's busy share (profiler kernel time over wall
   time) and peak memory, and for three of them the device time of each
   pipeline stage; each kernel timed on the recorded calls of the batched
   program and of the 1080p path;
7. print the ``kernels`` JSON line, the card line and the final status line.

Exits with 1 and prints no result when CUDA is not available.  Details go
to ``build/chip_smoke/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import relaxtpu_torch.models.vit as vit_mod
import relaxtpu_torch.ops.flow as flow_mod
from relaxtpu_torch import _native
from relaxtpu_torch.features.layout import segment_slices
from relaxtpu_torch.cli.__main__ import predict_batch, serve_loop
from relaxtpu_torch.features import pipeline as pipeline_mod
from relaxtpu_torch.features.pipeline import FARNEBACK_PARAMS, FeatureExtractor
from relaxtpu_torch.io.video import decode_video_inputs_i420
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.resnet import ResNet50
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.model.mlp import Mlp
from relaxtpu_torch.ops.attention import mha, mha_plain
from relaxtpu_torch.ops.boxsolve import MAX_WINSIZE, box_blur_solve, box_blur_solve_plain
from relaxtpu_torch.ops.flow import farneback_flow, pyramid_levels
from relaxtpu_torch.ops.warp import update_matrices, update_matrices_plain
from relaxtpu_torch.predict import VideoQualityPredictor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and compute rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# main-path shapes: 540p, 16 frames + 16 pairs, ViT-B/16 over F + 2P images
H, W, PAIRS, FRAMES = 540, 960, 16, 16
ATTN_SHAPE = (FRAMES + 2 * PAIRS, 197, 12, 64)
# serving shapes: four 540p clips, and one 1080p clip that takes the chunked path
SERVE_FRAMES = (32, 32, 27, 24)   # raw frames at 4 fps -> (16,16), (16,16), (14,13), (12,12)
SERVE_COUNTS = [(16, 16), (16, 16), (14, 13), (12, 12)]
H_HI, W_HI, FRAMES_HI = 1080, 1920, 40  # -> 20 frames, 20 pairs
COS_BOUND = {"f32": 0.99999, "bf16": 0.9999}
K1_FLOPS_PER_PX = 80    # corner weights, 5-plane gather, averaging, flow terms, taper, products
K2_FLOPS_PER_PX = 155   # 5 planes x 28 box adds, scaling, the 2x2 solve

TOL = {"K1": 1e-5, "K2": 1e-4, "K3_f32": 1e-4, "K3_bf16": 2e-2}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns: list, passes: int = 5) -> float | None:
    """Summed device time of the work that the calls in ``fns`` launch, in
    ms per pass over them, from torch.profiler's CUDA activity (no host or
    launch time); None when the profiler saw no device activity."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / passes if us > 0 else None


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|); raises on non-finite output."""
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check(name: str, rel: float, tol: float, verbose: bool = True) -> None:
    status = "ok" if rel <= tol else "FAIL"
    if verbose or rel > tol:
        print(f"  {name}: max error / max |plain| = {rel:.3e} (tolerance {tol:.0e}) {status}")
    if rel > tol:
        raise AssertionError(f"{name} disagrees with its plain version: {rel} > {tol}")


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nan_padded(t: torch.Tensor, extra: int = 4096) -> torch.Tensor:
    """A contiguous copy of ``t`` at the start of a larger NaN-filled
    allocation, so a read out of bounds poisons the result."""
    buf = torch.full((t.numel() + extra,), float("nan"), dtype=t.dtype, device=t.device)
    buf[: t.numel()].copy_(t.reshape(-1))
    return buf[: t.numel()].view(t.shape)


# ------------------------------------------------------------------ phase 2
def report_build(so: str) -> dict:
    """ptxas's registers and spills for every kernel function, and the count
    of tensor-core instructions (HMMA/HGMMA) in each K3 function's SASS
    (cuobjdump from the toolkit that built them); raises if a bf16 K3
    function has none."""
    funcs = {}
    for src in ("warp.cu", "boxsolve.cu", "attention.cu"):
        name = None
        for line in open(os.path.join(_native.BUILD_DIR, src + ".log")):
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                name = m.group(1)
                funcs[name] = {"source": src}
            elif name and "spill" in line:
                funcs[name]["spill"] = line.strip()
            elif name and (m := re.search(r"Used (\d+) registers", line)):
                funcs[name]["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
    name = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            funcs.setdefault(name, {})["tensor_core_instructions"] = 0
        elif name and "mha" in name and re.search(r"\bHG?MMA\b", line):
            funcs[name]["tensor_core_instructions"] += 1
    for name, f in funcs.items():
        kernel = re.search(r"(update_matrices|box_blur_solve|mha_bf16|mha_f32)_kernel", name)
        args = ",".join(re.findall(r"Li(\d+)E", name))
        f["kernel"] = f"{kernel.group(0) if kernel else name}<{args}>"
        mma = f"; {f['tensor_core_instructions']} HMMA/HGMMA" if "mha" in name else ""
        print(f"  {f.get('source')}: {f['kernel']}: {f.get('registers')} registers, {f.get('spill')}{mma}")
    bf16_mha = [f for n, f in funcs.items() if "mha_bf16" in n]
    if not bf16_mha or not all(f.get("tensor_core_instructions") for f in bf16_mha):
        raise AssertionError("a bf16 K3 function has no tensor-core instructions in its SASS")
    return funcs


# ------------------------------------------------------------------ phase 3
def check_flow_kernels(gen: torch.Generator) -> dict:
    """K1 and K2 against their plain versions at the four 540p and 1080p
    levels and the 4K finest level, with
    per-pixel random flows up to +-40 px (many corners clipped, many pixels
    outside) and NaN-padded inputs; K2 also at ragged shapes, at other odd
    windows, and refusing a window above its largest."""
    worst = {"K1": 0.0, "K2": 0.0}
    shapes = [(PAIRS, hk, wk, 15) for _, hk, wk in pyramid_levels(H, W)]
    shapes += [(PAIRS, hk, wk, 15) for _, hk, wk in pyramid_levels(H_HI, W_HI)]
    shapes += [(4, 2 * H_HI, 2 * W_HI, 15), (2, H_HI, W_HI, 5), (2, H_HI, W_HI, MAX_WINSIZE)]
    shapes += [(2, 16, 20, 15), (2, 67, 131, 15), (2, 67, 131, 5), (PAIRS, 135, 240, 5),
               (2, 67, 131, MAX_WINSIZE), (PAIRS, 135, 240, MAX_WINSIZE)]
    for p, hk, wk, ws in shapes:
        r0 = torch.randn((p, 5, hk, wk), generator=gen, device="cuda") * 50
        r1 = torch.randn((p, 5, hk, wk), generator=gen, device="cuda") * 50
        flow = (torch.rand((p, 2, hk, wk), generator=gen, device="cuda") * 2 - 1) * 40
        r0, r1, flow = nan_padded(r0), nan_padded(r1), nan_padded(flow)
        m = update_matrices(r0, r1, flow)
        err, rel = rel_err(m, update_matrices_plain(r0, r1, flow))
        check(f"K1 {p}x{hk}x{wk}", rel, TOL["K1"])
        worst["K1"] = max(worst["K1"], err)
        m = nan_padded(m)  # PSD normal-equation planes, as on the main path
        err, rel = rel_err(box_blur_solve(m, ws), box_blur_solve_plain(m, ws))
        check(f"K2 {p}x{hk}x{wk} winsize {ws}", rel, TOL["K2"])
        worst["K2"] = max(worst["K2"], err)
        del r0, r1, flow, m
        torch.cuda.empty_cache()
    m = torch.zeros((1, 5, 16, 16), device="cuda")
    try:
        box_blur_solve(m, MAX_WINSIZE + 2)
    except ValueError as e:
        print(f"  K2 winsize {MAX_WINSIZE + 2} refused: {e}")
    else:
        raise AssertionError(f"K2 took winsize {MAX_WINSIZE + 2}, above its largest")
    return worst


def check_attention_kernel(gen: torch.Generator) -> dict:
    """K3 in f32 and bf16 at the ViT shape and at N in {1, 17, 64, 197, 208,
    256} x D in {32, 64}, on contiguous NaN-padded inputs and on column
    slices of a NaN-padded packed qkv tensor."""
    cases = [ATTN_SHAPE] + [(2, n, 3, d) for n in (1, 17, 64, 197, 208, 256) for d in (32, 64)]
    worst = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        worst[f"K3_{tag}"] = 0.0
        for b, n, h, d in cases:
            scale = d**-0.5
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
            q, k, v = (nan_padded(qkv[..., i * h * d : (i + 1) * h * d].reshape(b, n, h, d)) for i in range(3))
            want = mha_plain(q, k, v, scale)
            err, rel = rel_err(mha(q, k, v, scale), want)
            check(f"K3 {tag} {(b, n, h, d)} contiguous", rel, TOL[f"K3_{tag}"])
            packed = nan_padded(qkv)
            qs, ks, vs = (packed[..., i * h * d : (i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
            err2, rel2 = rel_err(mha(qs, ks, vs, scale), want)
            check(f"K3 {tag} {(b, n, h, d)} packed-qkv slices", rel2, TOL[f"K3_{tag}"])
            worst[f"K3_{tag}"] = max(worst[f"K3_{tag}"], err, err2)
    return worst


def record_kernel_inputs(run) -> dict:
    """``run()`` (one more video or batch) with the three wrappers wrapped
    where the pipeline calls them, keeping every call's inputs."""
    calls = {"K1": [], "K2": [], "K3": []}
    saved = (flow_mod.update_matrices, flow_mod.box_blur_solve, vit_mod.mha)

    def keep(key, fn):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    flow_mod.update_matrices = keep("K1", update_matrices)
    flow_mod.box_blur_solve = keep("K2", box_blur_solve)
    vit_mod.mha = keep("K3", mha)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        flow_mod.update_matrices, flow_mod.box_blur_solve, vit_mod.mha = saved
    return calls


def time_on_main_path_inputs(calls: dict, tag: str, label: str = "main-path", verbose: bool = True) -> dict:
    """Per video (or batch): kernel, plain version (and SDPA for K3) timed on each
    recorded call and summed, by CUDA events around repeated calls (``ms``)
    and, for the kernel and SDPA, by the profiler's device durations alone
    (``device_ms``); the kernel held against the plain version on those
    inputs; the bound from those inputs' sizes."""
    kernel = {"K1": update_matrices, "K2": box_blur_solve, "K3": mha}
    plain = {"K1": update_matrices_plain, "K2": box_blur_solve_plain, "K3": mha_plain}
    out = {}
    for key, recorded in calls.items():
        r = {"calls": len(recorded), "err": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0 if key == "K3" else None, "bytes": 0.0, "flops": 0.0}
        kernel_fns, library_fns = [], []
        for args, kwargs in recorded:
            got, want = kernel[key](*args, **kwargs), plain[key](*args, **kwargs)
            err, rel = rel_err(got, want)
            tol = TOL[f"K3_{tag}"] if key == "K3" else TOL[key]
            check(f"{key} {tag} {label} call {tuple(args[0].shape)}", rel, tol, verbose)
            r["err"], r["rel"] = max(r["err"], err), max(r.get("rel", 0.0), rel)
            kernel_fns.append(lambda args=args, kwargs=kwargs: kernel[key](*args, **kwargs))
            r["ms"] += cuda_ms(kernel_fns[-1])
            r["plain_ms"] += cuda_ms(lambda: plain[key](*args, **kwargs), iters=5)
            if key == "K3":
                q, k, v = (t.transpose(1, 2) for t in args)
                library_fns.append(lambda q=q, k=k, v=v, scale=kwargs["scale"]:
                                   F.scaled_dot_product_attention(q, k, v, scale=scale))
                r["library_ms"] += cuda_ms(library_fns[-1])
                b, n, h, d = args[0].shape
                r["bytes"] += 4.0 * b * n * h * d * args[0].element_size()
                r["flops"] += 4.0 * b * h * n * n * d
            else:
                px = args[0].shape[0] * args[0].shape[-2] * args[0].shape[-1]
                r["bytes"] += px * (17 if key == "K1" else 7) * 4
                r["flops"] += px * (K1_FLOPS_PER_PX if key == "K1" else K2_FLOPS_PER_PX)
        r["bound_ms"], r["bound_by"] = bound(
            r["bytes"], r["flops"], args[0].dtype)
        r["device_ms"] = device_ms(kernel_fns)
        r["library_device_ms"] = device_ms(library_fns) if library_fns else None
        print(f"  {key} {tag} {label}: {r['calls']} calls (largest error / max |plain| {r['rel']:.3e}), "
              f"{r['ms']:.4f} ms "
              f"(device only {r['device_ms']}; plain {r['plain_ms']:.4f}; library {r['library_ms']}, "
              f"device only {r['library_device_ms']}; bound {r['bound_ms']:.4f} by {r['bound_by']})")
        out[key] = r
    return out


# ------------------------------------------------------------ phases 4 and 5
def seeded_states(vit_depth: int) -> tuple[dict, dict]:
    return (random_init_(ResNet50(), 0).state_dict(),
            random_init_(ViT(depth=vit_depth), 1).state_dict())


def synthetic_bgr(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """(n, h, w, 3) uint8: a blurred random texture panned smoothly (a few
    px per frame, inside the band of the JAX package's banded warp) plus
    noise, made on the device."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tex = torch.rand((3, 1, h + 24, w + 24), generator=gen, device="cuda") * 255
    x = torch.arange(-6, 7, device="cuda", dtype=torch.float32)
    g = torch.exp(-x * x / 8.0)
    g = g / g.sum()
    tex = F.conv2d(F.pad(tex, (6, 6, 0, 0), mode="reflect"), g.view(1, 1, 1, -1))
    tex = F.conv2d(F.pad(tex, (0, 0, 6, 6), mode="reflect"), g.view(1, 1, -1, 1))[:, 0]
    out = []
    for i in range(n):
        ox, oy = int(8 + 6 * math.sin(i / 3)), int(8 + 5 * math.cos(i / 4))
        fr = tex[:, oy : oy + h, ox : ox + w] + torch.randn((3, h, w), generator=gen, device="cuda") * 6
        out.append(fr.clamp(0, 255).to(torch.uint8).permute(1, 2, 0))
    return torch.stack(out).cpu().numpy()


def bgr_to_i420(bgr: np.ndarray) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR -> packed I420 (n, h*w*3/2), BT.601 limited."""
    img = bgr.astype(np.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    y = 0.257 * r + 0.504 * g + 0.098 * b + 16.0
    u = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
    v = 0.439 * r - 0.368 * g - 0.071 * b + 128.0
    sub = lambda c: (c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]) * 0.25  # noqa: E731
    u8 = lambda c: np.clip(np.rint(c), 0, 255).astype(np.uint8).reshape(len(bgr), -1)  # noqa: E731
    return np.concatenate([u8(y), u8(sub(u)), u8(sub(v))], axis=1)


def segment_cosines(a: np.ndarray, b: np.ndarray) -> dict:
    out = {}
    for name, sl in segment_slices().items():
        x, y = a[sl].astype(np.float64), b[sl].astype(np.float64)
        out[name] = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-30))
    return out


def check_cuda_vs_cpu() -> dict:
    rs, vs = seeded_states(vit_depth=2)
    frames = synthetic_bgr(4, 240, 320, seed=5)
    f, nxt = frames[0::2], frames[1::2]
    vecs = {}
    for dev in ("cpu", "cuda"):
        fx = FeatureExtractor(rs, vs, dtype=torch.float32, vit_depth=2, device=dev)
        vecs[dev] = fx.video_feature(f, f[: len(nxt)], nxt)
    cos = segment_cosines(vecs["cuda"], vecs["cpu"])
    for name, c in cos.items():
        print(f"  {name}: cosine(cuda, cpu) = {c:.8f} (bound 0.99999)")
        if not c >= 0.99999:
            raise AssertionError(f"CUDA vs CPU vector disagrees on {name}: {c}")
    return cos


def counts() -> dict:
    return {"K1": update_matrices.launches, "K2": box_blur_solve.launches, "K3": mha.launches}


def reset_counts() -> None:
    update_matrices.launches = box_blur_solve.launches = mha.launches = 0


def run_main_path() -> dict:
    os.makedirs(WORK_DIR, exist_ok=True)
    clip = os.path.join(WORK_DIR, "clip540p.yuv")
    bgr_to_i420(synthetic_bgr(32, H, W, seed=7)).tofile(clip)
    rs, vs = seeded_states(vit_depth=12)
    mlp_state = random_init_(Mlp(), 2).state_dict()
    scaler = FeatureScaler(fill=np.zeros(1), scale=np.ones(1), offset=np.zeros(1))
    fbuf, nbuf, h, w = decode_video_inputs_i420(clip, 4.0, W, H)
    if (len(fbuf), len(nbuf)) != (FRAMES, PAIRS):
        raise AssertionError(f"expected {FRAMES} frames and {PAIRS} pairs, got {len(fbuf)}, {len(nbuf)}")
    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        fx = FeatureExtractor(rs, vs, dtype=dtype, vit_depth=12, device="cuda")
        pred = VideoQualityPredictor(fx, mlp_state, scaler)
        reset_counts()
        mos = pred.predict_file(clip, framerate=4.0, width=W, height=H)
        n = counts()
        print(f"  {tag}: MOS {mos!r}, launches per video {n}")
        if not math.isfinite(mos):
            raise AssertionError(f"{tag} MOS is not finite: {mos}")
        if n != {"K1": 12, "K2": 12, "K3": 12}:
            raise AssertionError(f"{tag}: expected 12 launches of each kernel, got {n}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict_file(clip, framerate=4.0, width=W, height=H)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {tag}: warm ms per video {times} (median {statistics.median(times):.1f}), "
              f"max_memory_allocated {peak}")
        vec = fx.video_feature_i420(fbuf, nbuf, h, w)
        if vec.shape != (35203,) or not np.isfinite(vec).all():
            raise AssertionError(f"{tag} vector is not 35,203 finite values")
        kernels = time_on_main_path_inputs(
            record_kernel_inputs(lambda: pred.predict_file(clip, framerate=4.0, width=W, height=H)), tag)
        out[tag] = {
            "mos": mos, "launches": n, "warm_ms_median": statistics.median(times),
            "warm_ms": times, "max_memory_allocated": peak, "kernels": kernels, "vec": vec,
        }
        del fx, pred, kernels
        torch.cuda.empty_cache()
    cos = segment_cosines(out["bf16"].pop("vec"), out["f32"].pop("vec"))
    out["bf16_vs_f32_cosine"] = cos
    for name, c in cos.items():
        print(f"  {name}: cosine(bf16, f32) = {c:.8f} (bound 0.9999)")
        if not c >= 0.9999:
            raise AssertionError(f"bf16 vector drifts from f32 on {name}: {c}")
    return out


# ------------------------------------------------------------------ phase 6
@contextlib.contextmanager
def no_sync():
    """Any synchronising CUDA call inside raises (set back on the way out)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_counts(what: str, want: dict) -> dict:
    got = counts()
    print(f"  {what}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{what}: expected launches {want}, got {got}")
    return got


def check_cosines(what: str, got: np.ndarray, want: np.ndarray, bound_: float) -> dict:
    cos = segment_cosines(got, want)
    diff = float(np.abs(got.astype(np.float64) - want).max())
    print(f"  {what}: cosine per segment {[f'{c:.8f}' for c in cos.values()]} "
          f"(bound {bound_}), largest |difference| {diff:.3e}")
    if not got.shape == want.shape == (35203,) or not np.isfinite(got).all():
        raise AssertionError(f"{what}: not 35,203 finite values")
    if not min(cos.values()) >= bound_:
        raise AssertionError(f"{what}: cosine {cos} below {bound_}")
    return {"cosine": cos, "max_abs_diff": diff}


def flow_live_planes() -> dict:
    """Peak device memory that ``farneback_flow`` adds over its inputs, at
    1080x1920 with 16 pairs, in f32 planes a pair; raises if it exceeds the
    pipeline's working-set model (``FLOW_LIVE_PLANES``)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    prev = torch.randint(0, 256, (PAIRS, H_HI, W_HI), generator=gen, device="cuda", dtype=torch.uint8)
    nxt = torch.roll(prev, 3, dims=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    farneback_flow(prev, nxt, **FARNEBACK_PARAMS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    planes = peak / (PAIRS * H_HI * W_HI * 4)
    print(f"  flow at {H_HI}x{W_HI}, {PAIRS} pairs: peak {peak} B above its inputs = "
          f"{planes:.2f} f32 planes a pair (model: {pipeline_mod.FLOW_LIVE_PLANES})")
    if planes > pipeline_mod.FLOW_LIVE_PLANES:
        raise AssertionError(f"the flow holds {planes:.2f} planes a pair, above the model's "
                             f"{pipeline_mod.FLOW_LIVE_PLANES}")
    return {"peak_bytes": peak, "planes_per_pair": planes}


def backbone_peak(fx: FeatureExtractor, n_images: int) -> int:
    """max_memory_allocated over one backbone forward of ``n_images``
    224x224 images, weights included; raises if it exceeds the model's
    ``BACKBONE_PEAK_BYTES``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    imgs = torch.randint(0, 256, (n_images, 224, 224, 3), device="cuda", dtype=torch.uint8)
    with torch.inference_mode():
        fx._backbones(*fx._backbone_inputs(imgs, resize=False))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  backbones over {n_images} images: max_memory_allocated {peak} "
          f"(model: {pipeline_mod.BACKBONE_PEAK_BYTES:.0f})")
    if peak > pipeline_mod.BACKBONE_PEAK_BYTES:
        raise AssertionError(f"backbone peak {peak} above the model's {pipeline_mod.BACKBONE_PEAK_BYTES}")
    return peak


def timed(run, reps: int = 3) -> dict:
    """Warm wall ms of ``run()`` (median of ``reps``, ending in a
    synchronise), its peak memory, then one more run under the profiler:
    the device's busy share = summed kernel time / wall time of that run."""
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))) / 1e3
    return {"ms": times, "ms_median": statistics.median(times), "max_memory_allocated": peak,
            "profiled_wall_ms": wall, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall if kernel_ms > 0 else None}


def stage_breakdown(fx: FeatureExtractor, run) -> dict:
    """Device ms of each pipeline stage over one ``run()``: the profiler
    (CPU and CUDA activity) with a range around each stage, wrapped here and
    taken off after; the flow is inside the fragments stage.  Also the
    device's total, its count of ops (kernels and copies), the times a
    launch found the launch queue full, and the ten largest host ops by
    their own device time."""
    stages = {"colorspace": (pipeline_mod, "yuv420_to_bgr"), "flow": (pipeline_mod, "farneback_flow"),
              "fragments": (fx, "_fragments"), "backbone_inputs": (fx, "_backbone_inputs"),
              "backbones": (fx, "_backbones")}
    saved = {name: getattr(obj, attr) for name, (obj, attr) in stages.items()}

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        for name, (obj, attr) in stages.items():
            setattr(obj, attr, ranged(name, saved[name]))
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for name, (obj, attr) in stages.items():
            if obj is fx:
                delattr(fx, attr)
            else:
                setattr(obj, attr, saved[name])
    # The profiler also puts each range on the device's timeline as a span
    # named like the range; only the host-side range sums its kernels.
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    out = {name: sum(e.device_time_total for e in events if e.device_type == cpu and e.name == name) / 1e3
           for name in stages}
    device = [e for e in events if e.device_type == cuda and e.name not in stages]
    out["device_total"] = sum(e.time_range.elapsed_us() for e in device) / 1e3
    out["device_ops"] = len(device)
    out["launch_queue_full"] = sum(e.name == "Command Buffer Full" for e in events)
    ops = sorted((e for e in prof.key_averages() if e.device_type == cpu and e.key not in stages),
                 key=lambda e: -e.self_device_time_total)
    out["top_ops"] = [(e.key, e.self_device_time_total / 1e3, e.count) for e in ops[:10]]
    print(f"    stages, device ms: { {k: round(v, 3) for k, v in out.items() if k != 'top_ops'} }")
    print(f"    largest ops, own device ms (calls): {[(k, round(v, 3), c) for k, v, c in out['top_ops']]}")
    return out


def stream(pred: VideoQualityPredictor, clips: list, in_flight: int = 2) -> list:
    """Each clip through ``enqueue_file`` (under ``no_sync``) with
    ``in_flight`` enqueued -> the fetched vectors, in order."""
    pending, out = collections.deque(), []
    for clip in clips:
        with no_sync():
            pending.append(pred.enqueue_file(clip, framerate=4.0, width=W, height=H))
        while len(pending) > in_flight:
            out.append(pending.popleft().cpu().numpy())
    return out + [v.cpu().numpy() for v in pending]


def make_clip(name: str, n: int, h: int, w: int, seed: int) -> str:
    path = os.path.join(WORK_DIR, name)
    bgr_to_i420(synthetic_bgr(n, h, w, seed=seed)).tofile(path)
    return path


def run_serving() -> dict:
    rs, vs = seeded_states(vit_depth=12)
    mlp_state = random_init_(Mlp(), 2).state_dict()
    scaler = FeatureScaler(fill=np.zeros(1), scale=np.ones(1), offset=np.zeros(1))
    clips = [make_clip(f"serve{i}.yuv", n, H, W, seed=20 + i) for i, n in enumerate(SERVE_FRAMES)]
    clip_hi = make_clip("clip1080p.yuv", FRAMES_HI, H_HI, W_HI, seed=30)
    decoded = [decode_video_inputs_i420(c, 4.0, W, H) for c in clips]
    if [(len(d[0]), len(d[1])) for d in decoded] != SERVE_COUNTS:
        raise AssertionError(f"serving clips: expected {SERVE_COUNTS} frames and pairs")
    fbuf_hi, nbuf_hi, _, _ = decode_video_inputs_i420(clip_hi, 4.0, W_HI, H_HI)
    if (len(fbuf_hi), len(nbuf_hi)) != (FRAMES_HI // 2, FRAMES_HI // 2):
        raise AssertionError(f"1080p clip: expected {FRAMES_HI // 2} frames and pairs")
    total_pairs = sum(p for _, p in SERVE_COUNTS)
    n_images = sum(f + 2 * p for f, p in SERVE_COUNTS)
    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        fx = FeatureExtractor(rs, vs, dtype=dtype, vit_depth=12, device="cuda")
        pred = VideoQualityPredictor(fx, mlp_state, scaler)
        r = out[tag] = {"backbone_peak_172": backbone_peak(fx, n_images)}
        single = [fx.video_feature_i420(f, n, h, w) for f, n, h, w in decoded]
        chunk = fx.max_pair_batch(H, W)
        batch_args = ([d[0] for d in decoded], [d[1] for d in decoded], H, W)

        print(f"  ({tag}) (a) batched: {len(clips)} videos, {total_pairs} pairs in chunks of {chunk}, "
              f"{n_images} backbone images")
        reset_counts()
        with no_sync():
            vecs = fx.video_features_batch_i420(*batch_args)
        vecs = vecs.cpu().numpy()
        r["batched_launches"] = check_counts(
            f"{tag} batched", {"K1": 12 * -(-total_pairs // chunk), "K2": 12 * -(-total_pairs // chunk), "K3": 12})
        r["batched_vs_single"] = [check_cosines(f"{tag} batched video {i} vs single", v, s, COS_BOUND[tag])
                                  for i, (v, s) in enumerate(zip(vecs, single))]

        print(f"  ({tag}) (b) streaming through enqueue_file, 2 in flight")
        reset_counts()
        streamed = stream(pred, clips)
        r["stream_launches"] = check_counts(f"{tag} streaming", {k: 12 * len(clips) for k in ("K1", "K2", "K3")})
        r["stream_vs_single"] = [check_cosines(f"{tag} streamed video {i} vs single", v, s, 0.99999)
                                 for i, (v, s) in enumerate(zip(streamed, single))]

        print(f"  ({tag}) (c) 1080x1920, {len(nbuf_hi)} pairs: chunked path against unchunked")
        chunk_hi = fx.max_pair_batch(H_HI, W_HI)
        if len(nbuf_hi) <= chunk_hi:
            raise AssertionError(f"the 1080p clip should take the chunked path (chunk {chunk_hi})")
        reset_counts()
        with no_sync():
            vec_hi = fx.video_feature_async_i420(fbuf_hi, nbuf_hi, H_HI, W_HI)
        vec_hi = vec_hi.cpu().numpy()
        n_chunks = -(-len(nbuf_hi) // chunk_hi)
        r["chunked_launches"] = check_counts(
            f"{tag} 1080p chunked", {"K1": 12 * n_chunks, "K2": 12 * n_chunks, "K3": 12 * (1 + n_chunks)})
        reset_counts()
        with no_sync():
            vec_whole = fx.video_features_batch_i420([fbuf_hi], [nbuf_hi], H_HI, W_HI, chunk=0)
        vec_whole = vec_whole.cpu().numpy()[0]
        r["unchunked_launches"] = check_counts(f"{tag} 1080p unchunked", {"K1": 12, "K2": 12, "K3": 12})
        r["chunked_vs_unchunked"] = check_cosines(f"{tag} 1080p chunked vs unchunked", vec_hi, vec_whole,
                                                  COS_BOUND[tag])

        if tag == "bf16":
            print(f"  ({tag}) (d) serve loop: two clips and a bad line")
            want = [pred.predict_file(c, framerate=4.0, width=W, height=H) for c in clips[:2]]
            resp = io.StringIO()
            serve_loop(pred, iter([clips[0], json.dumps({"video": clips[1]}), "{not json"]), resp,
                       in_flight=2, defaults=dict(framerate=4.0, width=W, height=H))
            lines = [json.loads(line) for line in resp.getvalue().splitlines()]
            print(f"  serve responses: {lines}; predict_file MOS {want}")
            if (lines[0] != {"status": "ready"} or len(lines) != 4
                    or [ln.get("video") for ln in lines[1:3]] != clips[:2]
                    or any(abs(ln["predicted_mos"] - m) > 1e-5 for ln, m in zip(lines[1:3], want))
                    or lines[3]["video"] is not None or "error" not in lines[3]):
                raise AssertionError(f"serve loop answered {lines}")
            r["serve"] = lines

            print(f"  ({tag}) warm ms per video: one after the other, streamed (2 in flight), batched by 4")
            modes = {
                "sequential": lambda: [pred.predict_file(c, framerate=4.0, width=W, height=H) for c in clips],
                "streamed": lambda: predict_batch(pred, clips, 4.0, W, H, batch=1),
                "batched": lambda: predict_batch(pred, clips, 4.0, W, H, batch=len(clips)),
                # twelve videos: the pipeline's fill (first decode) and drain
                # (last fetch) weigh a third as much a video as with four
                "streamed_12": lambda: predict_batch(pred, clips * 3, 4.0, W, H, batch=1),
                "batched_12": lambda: predict_batch(pred, clips * 3, 4.0, W, H, batch=len(clips)),
                "1080p_chunked": lambda: pred.predict_file(clip_hi, framerate=4.0, width=W_HI, height=H_HI),
            }
            r["timing"] = {}
            for mode, run in modes.items():
                t = r["timing"][mode] = timed(run)
                per = {"1080p_chunked": 1, "streamed_12": 3 * len(clips), "batched_12": 3 * len(clips)}.get(
                    mode, len(clips))
                print(f"  {mode}: {t['ms_median'] / per:.2f} ms per video (runs {t['ms']} for {per}), "
                      f"busy share {t['busy_share']}, max_memory_allocated {t['max_memory_allocated']}")
            r["stages"] = {}
            for mode in ("sequential", "batched", "1080p_chunked"):
                print(f"  ({tag}) where the device time goes: {mode}")
                r["stages"][mode] = stage_breakdown(fx, modes[mode])

        print(f"  ({tag}) kernels on the serving shapes")
        r["kernels"] = {
            "batched_540p_v4": time_on_main_path_inputs(
                record_kernel_inputs(lambda: fx.video_features_batch_i420(*batch_args)), tag, "batched", False),
            "chunked_1080p": time_on_main_path_inputs(
                record_kernel_inputs(lambda: fx.video_feature_async_i420(fbuf_hi, nbuf_hi, H_HI, W_HI)),
                tag, "1080p", False),
        }
        del fx, pred
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = gpu_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _native.lib()
    build_s = time.perf_counter() - t0
    print(f"[2] kernels built and loaded in {build_s:.1f} s")
    build_info = report_build(_native.build())

    print("[3] kernels against their plain versions (540p, 1080p and 4K shapes)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stress = check_flow_kernels(gen) | check_attention_kernel(gen)
    torch.cuda.synchronize()
    flow_mem = flow_live_planes()

    print("[4] CUDA run against CPU run (2 frames, 240x320, depth-2 ViT, f32)")
    cos_cpu = check_cuda_vs_cpu()

    print("[5] main path: 540x960, 16 frames + 16 pairs, ResNet-50 + ViT-B/16 depth 12")
    main_res = run_main_path()

    print("[6] serving paths: batched, streamed, 1080p chunked, serve loop")
    serving = run_serving()

    sources = {"K1": ("update_matrices", "relaxtpu_torch/csrc/warp.cu", "relaxtpu/ops/warp.py:234"),
               "K2": ("box_blur_solve", "relaxtpu_torch/csrc/boxsolve.cu", "relaxtpu/ops/boxsolve.py:47"),
               "K3": ("mha", "relaxtpu_torch/csrc/attention.cu", "relaxtpu/ops/attention.py:34")}
    kernels = []
    rows = [(key, "bf16") for key in sources] + [("K3", "f32")]
    for key, tag in rows:
        name, src, rep = sources[key]
        r = main_res[tag]["kernels"][key]
        shapes = {shape: {k: v[key][k] for k in ("calls", "ms", "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "library_device_ms")}
                  for shape, v in serving[tag]["kernels"].items()}
        kernels.append({
            "name": f"{key} {name}" + (" (f32)" if tag == "f32" else ""), "route": "cuda",
            "source": src, "replaces": rep, "launches": main_res[tag]["launches"][key],
            "max_abs_err": max([r["err"], stress[key if key != "K3" else f"K3_{tag}"]]
                               + [v[key]["err"] for v in serving[tag]["kernels"].values()]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
            "serving_shapes": shapes,
        })

    with open(os.path.join(WORK_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_s": build_s, "build": build_info, "kernels": kernels,
                   "stress_max_abs_err": stress,
                   "flow_live_planes_1080p": flow_mem, "cuda_vs_cpu_cosine": cos_cpu,
                   "main_path": main_res, "serving": serving}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

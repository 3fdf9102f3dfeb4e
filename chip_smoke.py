"""Smoke run of the PyTorch/CUDA port (``relaxtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``relaxtpu_torch/csrc`` and time the build;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the 540p main path: K1 (matrix update) and K2 (box blur +
   solve) at the four pyramid levels with 16 pairs and per-pixel random
   flows up to +-40 px, K3 (attention) at (48, 197, 12, 64) in f32 and
   bf16; every input sits at the start of a NaN-filled allocation;
4. the 35,203 vector of a CUDA run against a CPU run (2 frames, 240x320,
   depth-2 ViT, f32 with TF32 off): per-segment cosine >= 0.99999;
5. the full-width main path: a seeded 540x960 raw I420 clip of 32 frames at
   4 fps (16 frames, 16 pairs) through ``VideoQualityPredictor.predict_file``
   with seeded ResNet-50, ViT-B/16 (depth 12) and MLP weights, in bf16 and
   in f32; K1, K2 and K3 must each launch 12 times per video, the MOS must
   be finite and the bf16 vector within cosine 0.9999 of the f32 one;
   then one more video records every kernel call's inputs, and each kernel,
   its plain version and (for K3) ``F.scaled_dot_product_attention`` are
   checked and timed on exactly those inputs (CUDA events), per video;
6. print the ``kernels`` JSON line, the card line and the final status line.

Exits with 1 and prints no result when CUDA is not available.  Details go
to ``build/chip_smoke/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
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
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io.video import decode_video_inputs_i420
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.resnet import ResNet50
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.model.mlp import Mlp
from relaxtpu_torch.ops.attention import mha, mha_plain
from relaxtpu_torch.ops.boxsolve import box_blur_solve, box_blur_solve_plain
from relaxtpu_torch.ops.flow import pyramid_levels
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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|); raises on non-finite output."""
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check(name: str, rel: float, tol: float) -> None:
    status = "ok" if rel <= tol else "FAIL"
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


# ------------------------------------------------------------------ phase 3
def check_flow_kernels(gen: torch.Generator) -> dict:
    """K1 and K2 against their plain versions at the four 540p levels, with
    per-pixel random flows up to +-40 px (many corners clipped, many pixels
    outside) and NaN-padded inputs."""
    worst = {"K1": 0.0, "K2": 0.0}
    for _, hk, wk in pyramid_levels(H, W):
        r0 = torch.randn((PAIRS, 5, hk, wk), generator=gen, device="cuda") * 50
        r1 = torch.randn((PAIRS, 5, hk, wk), generator=gen, device="cuda") * 50
        flow = (torch.rand((PAIRS, 2, hk, wk), generator=gen, device="cuda") * 2 - 1) * 40
        r0, r1, flow = nan_padded(r0), nan_padded(r1), nan_padded(flow)
        m = update_matrices(r0, r1, flow)
        err, rel = rel_err(m, update_matrices_plain(r0, r1, flow))
        check(f"K1 {hk}x{wk}", rel, TOL["K1"])
        worst["K1"] = max(worst["K1"], err)
        m = nan_padded(m)  # PSD normal-equation planes, as on the main path
        err, rel = rel_err(box_blur_solve(m, 15), box_blur_solve_plain(m, 15))
        check(f"K2 {hk}x{wk}", rel, TOL["K2"])
        worst["K2"] = max(worst["K2"], err)
    return worst


def check_attention_kernel(gen: torch.Generator) -> dict:
    """K3 at the ViT shape, f32 and bf16, contiguous NaN-padded inputs and
    column slices of a NaN-padded packed qkv tensor."""
    b, n, h, d = ATTN_SHAPE
    scale = d**-0.5
    worst = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
        q, k, v = (qkv[..., i * h * d : (i + 1) * h * d].reshape(b, n, h, d).contiguous() for i in range(3))
        q, k, v = nan_padded(q), nan_padded(k), nan_padded(v)
        want = mha_plain(q, k, v, scale)
        err, rel = rel_err(mha(q, k, v, scale), want)
        check(f"K3 {tag} {ATTN_SHAPE}", rel, TOL[f"K3_{tag}"])
        packed = nan_padded(qkv)
        qs, ks, vs = (packed[..., i * h * d : (i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
        err2, rel2 = rel_err(mha(qs, ks, vs, scale), want)
        check(f"K3 {tag} packed-qkv slices", rel2, TOL[f"K3_{tag}"])
        worst[f"K3_{tag}"] = max(err, err2)
    return worst


def record_kernel_inputs(pred: VideoQualityPredictor, clip: str) -> dict:
    """One more video through ``predict_file`` with the three wrappers
    wrapped where the main path calls them, keeping every call's inputs."""
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
        pred.predict_file(clip, framerate=4.0, width=W, height=H)
    finally:
        flow_mod.update_matrices, flow_mod.box_blur_solve, vit_mod.mha = saved
    return calls


def time_on_main_path_inputs(calls: dict, tag: str) -> dict:
    """Per video: kernel, plain version (and SDPA for K3) timed on each
    recorded call and summed; the kernel held against the plain version on
    those inputs; the bound from those inputs' sizes."""
    kernel = {"K1": update_matrices, "K2": box_blur_solve, "K3": mha}
    plain = {"K1": update_matrices_plain, "K2": box_blur_solve_plain, "K3": mha_plain}
    out = {}
    for key, recorded in calls.items():
        r = {"calls": len(recorded), "err": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0 if key == "K3" else None, "bytes": 0.0, "flops": 0.0}
        for args, kwargs in recorded:
            got, want = kernel[key](*args, **kwargs), plain[key](*args, **kwargs)
            err, rel = rel_err(got, want)
            check(f"{key} {tag} main-path call {tuple(args[0].shape)}", rel,
                  TOL[f"K3_{tag}"] if key == "K3" else TOL[key])
            r["err"] = max(r["err"], err)
            r["ms"] += cuda_ms(lambda: kernel[key](*args, **kwargs))
            r["plain_ms"] += cuda_ms(lambda: plain[key](*args, **kwargs), iters=5)
            if key == "K3":
                q, k, v = (t.transpose(1, 2) for t in args)
                r["library_ms"] += cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=kwargs["scale"]))
                b, n, h, d = args[0].shape
                r["bytes"] += 4.0 * b * n * h * d * args[0].element_size()
                r["flops"] += 4.0 * b * h * n * n * d
            else:
                px = args[0].shape[0] * args[0].shape[-2] * args[0].shape[-1]
                r["bytes"] += px * (17 if key == "K1" else 7) * 4
                r["flops"] += px * (K1_FLOPS_PER_PX if key == "K1" else K2_FLOPS_PER_PX)
        r["bound_ms"], r["bound_by"] = bound(
            r["bytes"], r["flops"], args[0].dtype)
        print(f"  {key} {tag}: {r['calls']} calls, {r['ms']:.4f} ms per video "
              f"(plain {r['plain_ms']:.4f}, library {r['library_ms']}, "
              f"bound {r['bound_ms']:.4f} by {r['bound_by']})")
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
        kernels = time_on_main_path_inputs(record_kernel_inputs(pred, clip), tag)
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
    for src in ("warp.cu", "boxsolve.cu", "attention.cu"):
        log = os.path.join(_native.BUILD_DIR, src + ".log")
        if os.path.exists(log):
            for line in open(log):
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")

    print("[3] kernels against their plain versions (540p shapes)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stress = check_flow_kernels(gen) | check_attention_kernel(gen)
    torch.cuda.synchronize()

    print("[4] CUDA run against CPU run (2 frames, 240x320, depth-2 ViT, f32)")
    cos_cpu = check_cuda_vs_cpu()

    print("[5] main path: 540x960, 16 frames + 16 pairs, ResNet-50 + ViT-B/16 depth 12")
    main_res = run_main_path()

    sources = {"K1": ("update_matrices", "relaxtpu_torch/csrc/warp.cu", "relaxtpu/ops/warp.py:234"),
               "K2": ("box_blur_solve", "relaxtpu_torch/csrc/boxsolve.cu", "relaxtpu/ops/boxsolve.py:47"),
               "K3": ("mha", "relaxtpu_torch/csrc/attention.cu", "relaxtpu/ops/attention.py:34")}
    kernels = []
    bf16 = main_res["bf16"]
    for key, (name, src, rep) in sources.items():
        r = bf16["kernels"][key]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": src, "replaces": rep,
            "launches": bf16["launches"][key],
            "max_abs_err": max(r["err"], stress[key if key != "K3" else "K3_bf16"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })

    with open(os.path.join(WORK_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_s": build_s, "kernels": kernels, "stress_max_abs_err": stress,
                   "cuda_vs_cpu_cosine": cos_cpu, "main_path": main_res}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

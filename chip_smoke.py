"""Smoke run of the PyTorch/CUDA port (``relaxtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is not 0):

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``relaxtpu_torch/csrc`` and time the build;
   print each kernel function's registers and spills (ptxas) and the count
   of tensor-core instructions in each K3 function's SASS (cuobjdump),
   failing if a bf16 K3 function (short or long) has none, if the long K3
   (the bf16 ring kernel and the f32 one-pass kernel at D 32 and 64 among
   them), the generic-radius K2, the wide-window K2 or the polynomial
   expansion functions are missing, or if the ring kernel, the one-pass
   kernel, the generic-radius K2, either wide-window K2 pass or the
   expansion spills;
3. hold each kernel against its plain PyTorch version on the card: K1
   (matrix update) and K2 (box blur + solve) at the four 540p and the four
   1080p pyramid levels with 16 pairs, at the 4K finest level (2160x3840)
   with 4 pairs, with per-pixel random flows up to +-40 px, and at 16x20
   and 67x131; K2 also at winsize 5 and 17 (and at 1080x1920 with 2 pairs),
   at the windows past 17 (``WIDE_WINDOWS``: the generic-radius kernel's
   and the wide route's, each call counted, the first window whose
   vertical ring does not fit among them) on the 540p levels, 16x20 and
   67x131 and on one pair at the edges of the plan of the route that takes
   the window, aligned and offset by one float, each bit-identical to the
   plain version; the wide route with both passes' taps in chunks, by a
   plan that forces them; and winsize 17 then 19 launching the strip kernel
   then the generic one; K3 (attention) at
   (48, 197, 12, 64) and at N in {1, 17, 64, 197, 208, 256} x D in {32, 64}
   (the short entries) and N in {257, 300, 577, 1025} x D in {32, 64, 80,
   128, 256} and N in {383, 384, 385, 640, 641} x D in {32, 64} (the long
   entries; the last set straddles the bf16 ring kernel's 128-query blocks
   and the 64-query blocks and 64-key tiles of both long kernels) and N in
   {264, 265, 272, 273, 288, 289} x D in {32, 64} (the widths 8, 16, 32 and
   64 of the f32 one-pass kernel's last key tile), in f32 and bf16,
   contiguous and as packed-qkv slices,
   each call launching the entry ``_plan`` names; the
   long entry called directly at N = 197 and 256 against the short one;
   every input sits at the start of a NaN-filled allocation; the
   polynomial expansion (``csrc/polyexp.cu``) against its plain version
   with ``torch.equal`` on the card and against the CPU, at the 540p and
   1080p levels with 16 pairs and at radii 1-60 (the run-time-radius
   kernel but at 5) on the edges of its plan, aligned and offset, into
   NaN-filled outputs (``check_poly_expansion``); the pyramid level
   (``csrc/pyramid.cu``) against its plain version: its smoothing with
   ``torch.equal``, the level within 2 ulps, uint8 and f32 grey, at the
   540p and 1080p levels with 16 pairs, ragged shapes and radii up to
   ``PYR_RMAX`` (``check_pyramid_level``), each level timed beside its
   bound and the plain version, and the flow with the kernel against the
   flow with the plain level (``time_pyramid_levels``); then the
   flow's live f32 planes a pair at 1080p (``max_memory_allocated`` around
   ``farneback_flow``, 16 pairs) must fit the pipeline's working-set model;
   the long K3 timed at (48, 577, 12, 64) (ViT-B/16 at 384x384) and at the
   main path's (48, 197, 12, 64) beside the short entry, SDPA beside both,
   in bf16 and f32; ``farneback_flow(winsize=21)`` on 2 pairs of the 540p
   clip, CUDA against CPU (mean <= 1e-3 px, p99 <= 1e-2 px), with the counts
   set to 0 before it: K1 = K2 = 12, all 12 K2 on the generic kernel;
4. the 35,203 vector of a CUDA run against a CPU run (2 frames, 240x320,
   depth-2 ViT, f32 with TF32 off): per-segment cosine >= 0.99999;
5. the full-width main path: a seeded 540x960 raw I420 clip of 32 frames at
   4 fps (16 frames, 16 pairs) through ``VideoQualityPredictor.predict_file``
   with seeded ResNet-50, ViT-B/16 (depth 12) and MLP weights, in bf16 and
   in f32; K1, K2 and K3 must each launch 12 times per video and the
   expansion and the pyramid 4 times each (8 on phase 6's 1080p chunked
   path), the MOS must
   be finite and the bf16 vector within cosine 0.9999 of the f32 one;
   then one more video records every kernel call's inputs, and each kernel,
   its plain version and (for K3) ``F.scaled_dot_product_attention`` are
   checked and timed on exactly those inputs, per video: CUDA events
   around repeated calls, and the profiler's device durations alone; none
   of the 12 K2 and K3 launches is on the generic K2 or the long K3; the
   generic K2 at winsize 21 and the wide route at 67 timed on the recorded
   K2 inputs beside the strip kernel at 15, by level and (the wide route)
   by kernel function, against a bound that counts K2's adds at the add
   rate (``F32_ADDS_PER_S``);
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
7. training of the MLP head at full width (35,203 -> 256 -> 128 -> 1), f32
   with TF32 off, on seeded low-rank features (``x = z @ A + 0.1 noise``,
   z in R^16, the MOS a monotone function of z plus noise, a few NaN/inf
   entries), launch counts of K1-K3 set to 0 before and 0 after:
   (a) ``train`` through the CLI function in-process, KoNViD-1k shape
       (1,200 x 35,203, MOS 1-5, default ``TrainConfig``: 10 folds, 20
       epochs, batch 256, SGD lr 0.1, SWA from epoch 14, BN) with 2
       repeats instead of 21; median test SRCC >= ``SRCC_MIN``; the saved
       ``.npz`` through the predictor's loader reproduces
       ``trainer.predict`` (atol 1e-5) and scores phase 5's 540p vector
       into a finite MOS;
   (b) the first fold of (a) for 2 epochs (dropout 0, SWA off), same init
       and permutations, on the card and on the CPU, with (a)'s head and
       with (c)'s (no BN, lr 1e-2): parameters, BN buffers and epoch
       losses within rtol 2e-3, atol 2e-4;
   (c) ``train-lsvq``, LSVQ shape: 28,056 train x 7,400 test videos, the
       train features read as two ``.mat`` chunks; peak device memory and
       the host's peak RSS;
   (d) ``finetune`` and ``finetune --zero-shot`` from (c)'s snapshot on
       (a)'s features (min-max scaled), 2 repeats; every metric finite;
   every epoch's step loop of (a)-(d) runs under
   ``torch.cuda.set_sync_debug_mode("error")``; printed: ms a training step
   at batch 256 (CUDA events over an epoch's steps, and the profiler's
   device time over 40 steps) against its bound, the wall time of (a)'s
   repeats and (c)'s run split into host preprocessing, device epochs,
   per-epoch evaluation and its ``curve_fit``, the device's busy share
   over a profiled epoch, and peak device memory;
8. extraction at full width (ResNet-50, ViT-B/16 depth 12, seeded, bf16)
   through ``cli.main(["extract", ...])``, launch counts set to 0 before
   each run and read after it, on four LIVE-Qualcomm-shaped raw clips
   (1080x1920, 40 frames at 4 fps: 20 frames and 20 pairs, two chunks):
   (a) ``--mode full`` with ``--save-mat``, every enqueue under
       ``set_sync_debug_mode("error")``: K1 = K2 = 24 and K3 = 36 a video,
       each stored row against ``video_feature_i420`` of its clip, the
       ``.npy`` matrix against the rows, the ``.mat`` through
       ``load_mat_features``, a second run that skips every video (no
       launch, same matrix); warm ms per video of a fresh run (4 decode
       threads, 2 videos enqueued ahead), busy share, peak memory;
   (b) the 24 other (mode, network, layer) combinations on one clip: the
       stored matrix's rows and width, finite values, K1-K3 launches, ms
       per video (cold and warm) and the warm run's host time in the
       decode and in the enqueue;
   (c) every mode on the card against the CPU (240x320, 2 frames and 2
       pairs, depth-2 ViT, f32 with TF32 off): cosine >= 0.99999;
   (d) VGG-16 with seeded weights, batch 16 at 224x224: CUDA f32 against
       CPU f32 (each tap and fc2 within 1e-4 of its max), bf16 against f32
       (per-tap cosine >= 0.999), ms per batch by events and peak memory;
   (e) ``--profile-dir`` writes one trace with the card's kernels in it;
   and the phase's seconds by step;
9. ingest at full width (ResNet-50, ViT-B/16 depth 12, seeded, bf16; the
   card's host has cv2 but not libav, so (a)-(d) run what follows a
   container's decode on seeded frames and (e) decodes a real mp4 through
   cv2), launch counts set to 0 before each run and read after it:
   (a) a seeded 540x960 raw clip (16 frames, 16 pairs): the BGR program
       (``video_feature_async``, under ``set_sync_debug_mode("error")``) on
       the host converter's frames against the I420 program on the clip's
       bytes, bit-identical; K1 = K2 = K3 = 12; the bytes each uploads
       (frames once); warm ms a video of each ingest, busy share, peak
       memory;
   (b) ``predict_arrays`` against ``predict_feature`` of (a)'s vector;
   (c) ``predict_batch`` with ``--batch 2`` on five seeded clips, 540p and
       360p interleaved, through an injected decode: rows in input order,
       each against its single-video vector (phase 6's bound), launches;
   (d) a 540p clip with no pairs: NaN in exactly the 19,779 fragment
       entries, a finite MOS, K1 = K2 = 0, K3 = 12;
   (e) whether the native decoder and cv2 load; ``predict_file`` on an
       mp4 with both forced off raising the port's named error; where cv2
       loads (it does on the card's host), a seeded 540p mp4 written and
       decoded through it into the BGR program (K1 = K2 = K3 = 12, the
       vector of the decoded frames);
   (f) ``warmup 540x960 x 16`` through the CLI, ``measure_link`` and the
       mode ``pick_serving_mode`` picks;
   (g) ``resolve_device("cuda:1")`` refused;
10. the multi-device layer (``relaxtpu_torch.parallel``) on the one card
   (NCCL places one rank on one device, so several ranks share it through
   gloo):
   (a) world size 1 under NCCL (a ``file://`` store in ``build/``):
       ``ShardedVideoEvaluator.run`` over phase 6's four 540p clips, rows
       bit-identical to phase 6's bf16 streamed vectors, K1 = K2 = K3 = 12
       a video, every kernel library call inside ``_native.launch``'s
       device guard; ``DistributedMlpTrainStep`` at 35,203 x 256, batch
       256, dropout 0, f32 with TF32 off, 20 steps against the one-process
       step from the same init (loss and parameters within 1e-5 relative),
       and both steps' ms by events, device ms and launches;
   (b) ``extract --mode full --n-data 2`` (``cli.main`` in two ranks
       started as torch.multiprocessing starts them, both on cuda:0)
       over phase 8's four 1080p clips: the matrix equal to phase 8's
       one-process matrix bit for bit, each rank's launches summing to the
       one-process counts, warm wall ms a video against phase 8's;
   (c) four ranks, a 2 x 2 mesh: 3 DP x TP steps at the real head shape
       equal to (a)'s one-process steps within 1e-5 relative, the fc1 pad
       row zero;
   (d) ``resolve_device`` refuses the index past the device count, naming
       the count;
11. the tools, full width (ResNet-50, ViT-B/16 depth 12, seeded), launch
   counts set to 0 before each run and read after it:
   (a) ``visualize`` through ``cli.main`` on a seeded 540x960 frame pair
       written as PNGs, in bf16 and in f32, three calls each: the overlay
       at the frame's shape, its 196 positions equal to
       ``fragment_positions`` on the CPU, K3 = depth - 1 = 11 and no K1 or
       K2 a call, the attention rows summing to 1 within the activation
       type's rounding (2^-8 bf16, 1e-5 f32), the bf16 CLS map within
       cosine 0.999 of the f32 one, ms a call; the f32 ViT's tokens at
       240x256 (241 tokens through the short K3, the position table
       resized) against the CPU's within 1e-4 of the largest; at 256x256
       and 384x384 (257 and 577 tokens: the long K3, ``depth`` launches,
       the counts set to 0 before each) in f32 within 1e-4 of the CPU's
       largest token and in bf16 within cosine 0.999 of the CPU's f32;
   (b) ``parity.production_numerics()`` on the card: Farneback flow (K1,
       K2) against cv2 (mean <= 5e-3 px, p99 <= 5e-2 px) and the bf16
       vector against the f32 one (cosine >= 0.9999, median relative
       error <= 5e-2), with the launches;
   (c) whether PIL imports (the features check's reference resizes with
       it); where it does, ``parity --check features`` on the card (the
       f32 pipeline; the reference on the CPU): every segment within its
       bounds, exit code 0, the launches;
   (d) where PIL imports, ``parity --check all`` with no blobs: ``ran`` 2
       (features and production), ``ok``, head and demo skipped with
       their missing flags named;
12. K4 (``ops/window_attention.py``, FAST-VQA's windowed attention): against
   ``window_mha_plain`` in f32 on the same bf16 qkv at FAST-VQA's four stage
   geometries (4 views; grids 16x56x56 to 16x7x7, 3-24 heads, the gate on
   stages 1-3), unshifted and shifted, and at edge windows (49, 30, 98 and
   512 tokens, several windows an axis, shifts on every axis), each input
   NaN-padded, within ``TOL["K4"]`` of max |plain| and one launch a call;
   each stage's call by events and device time beside its bound, and the 12
   calls of a view batch; then FAST-VQA's program on a seeded 540p video
   (4 views of 32 frames): the host crop routine bit-identical to numpy's
   (both timed), the mosaic bit-identical to the reference's whole-frame
   conversion and crop, the CUDA-graph program's answer against the eager
   one's, two enqueues under ``set_sync_debug_mode("error")`` (the second
   launches the first video: 12 K4 launches), warm ms a video and peak
   memory, and the bf16
   answer and the fp8 control against the f32 reference (the benchmark's
   numbers ``head_map``, ``feat``, ``score``);
13. print the seconds of each phase (phases 3 and 5-12 also by step), the
   ``kernels`` JSON line, the card line and the final status line.

``python3 chip_smoke.py k4`` runs phases 1, 2 and 12 alone; ``python3
chip_smoke.py pyramid`` phases 1 and 2, the pyramid's checks and times and
the flow's live planes.  Exits with 1 and prints no result when CUDA is not
available.  Details go to ``build/chip_smoke/chip_smoke.json``
(``chip_smoke_k4.json`` for ``k4``, ``chip_smoke_pyramid.json`` for
``pyramid``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import datetime
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

import relaxtpu_torch.model.protocol as protocol_mod
import relaxtpu_torch.model.train as train_mod
import relaxtpu_torch.models.vit as vit_mod
import relaxtpu_torch.ops.flow as flow_mod
from relaxtpu_torch import _native
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.data.splits import kfold_split, split_other
from relaxtpu_torch.data.store import FeatureStore, load_mat_features
from relaxtpu_torch.features.ablation import AblationExtractor
from relaxtpu_torch.features.layout import TOTAL_FEATURE_DIM, segment_slices
from relaxtpu_torch.cli.__main__ import predict_batch, serve_loop
from relaxtpu_torch.features import pipeline as pipeline_mod
from relaxtpu_torch.features.pipeline import FARNEBACK_PARAMS, FeatureExtractor
from relaxtpu_torch.io import native
from relaxtpu_torch.io.video import DecoderUnavailable, _yuv420_to_bgr_limited, decode_video, decode_video_inputs_i420
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.resnet import ResNet50
from relaxtpu_torch.models.vgg import VGG16
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.model.mlp import Mlp, flax_init_
from relaxtpu_torch.models.porters import mlp_from_jax
from relaxtpu_torch import reference_fastvqa
from relaxtpu_torch.features import fastvqa as fastvqa_mod
from relaxtpu_torch.features.fastvqa import FastVQAExtractor
from relaxtpu_torch.models.swin3d import random_state
from relaxtpu_torch.ops import attention as attention_mod
from relaxtpu_torch.ops import window_attention
from relaxtpu_torch.ops.attention import mha, mha_plain
from relaxtpu_torch.ops import boxsolve as boxsolve_mod
from relaxtpu_torch.ops.boxsolve import GENERIC_WINSIZE, STRIP_WINSIZE, box_blur_solve, box_blur_solve_plain
from relaxtpu_torch.ops.colorspace import bgr_to_gray
from relaxtpu_torch.ops.flow import (
    POLY_NMAX, POLY_SPAN, PYR_RMAX, farneback_flow, poly_expansion, poly_expansion_plain, pyramid_level, pyramid_levels,
)
from relaxtpu_torch.ops.warp import update_matrices, update_matrices_plain
from relaxtpu_torch.parallel.distributed import initialize
from relaxtpu_torch.parallel.eval import ShardedVideoEvaluator
from relaxtpu_torch.parallel.mesh import make_mesh, shard_batch
from relaxtpu_torch.parallel.train_dp import DistributedMlpTrainStep
from relaxtpu_torch.predict import VideoQualityPredictor
from relaxtpu_torch.device import resolve_device
from relaxtpu_torch.utils.checkpoint import load_snapshot_variables
from relaxtpu_torch.utils.linkprobe import measure_link, pick_serving_mode

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and compute rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# K2's work is adds: the card issues one a lane a cycle, half the data sheet's f32 rate, which counts an
# FMA as two operations (132 SMs x 128 lanes x 1.98 GHz)
F32_ADDS_PER_S = PEAK_FLOPS[torch.float32] / 2

# main-path shapes: 540p, 16 frames + 16 pairs, ViT-B/16 over F + 2P images
H, W, PAIRS, FRAMES = 540, 960, 16, 16
ATTN_SHAPE = (FRAMES + 2 * PAIRS, 197, 12, 64)
# serving shapes: four 540p clips, and one 1080p clip that takes the chunked path
SERVE_FRAMES = (32, 32, 27, 24)   # raw frames at 4 fps -> (16,16), (16,16), (14,13), (12,12)
SERVE_COUNTS = [(16, 16), (16, 16), (14, 13), (12, 12)]
H_HI, W_HI, FRAMES_HI = 1080, 1920, 40  # -> 20 frames, 20 pairs
COS_BOUND = {"f32": 0.99999, "bf16": 0.9999}
K1_FLOPS_PER_PX = 80    # corner weights, 5-plane gather, averaging, flow terms, taper, products
LONG_ATTN_SHAPE = (FRAMES + 2 * PAIRS, 577, 12, 64)  # ViT-B/16 at 384x384
RING_EDGES = (383, 384, 385, 640, 641)  # about 3 query blocks of 128 (6 of 64) and 10 key tiles of 64
TAIL_EDGES = (264, 265, 272, 273, 288, 289)  # the f32 one-pass kernel's last tile: 8 | 16 | 32 | 64 keys
# K2 past the strip kernel's largest window: the generic-radius kernel's route (19, 21); the wide route
# above it, at every R mod 4 (the scratch's column offset) among windows the generic kernel also takes
# (its plan's changes at 27 and 35, its largest at 65), taller than the 540p levels' smallest (101,
# 131), and at its first window whose vertical ring does not fit a block, so the taps run in chunks
FIRST_CHUNKED = boxsolve_mod._wide_taps(10**6) + 2
WIDE_WINDOWS = (19, 21, 23, 25, 27, 31, 33, 35, 63, 65, 67, 69, 101, 131, FIRST_CHUNKED)
WIDE_WINSIZE = 21                # the slice's flow window
PAIR_WINSIZE = 67                # the wide route's flow window


def k2_flops_per_px(winsize: int = 15) -> int:
    """5 planes x 2 (winsize - 1) box adds, scaling, the 2x2 solve: 155 at 15."""
    return 10 * (winsize - 1) + 15

# the polynomial expansion's rounded products and adds a pixel at radius n (206 at 5), at the add rate
def pe_flops_per_px(n: int = 5) -> int:
    return 18 * (2 * n + 1) + 8

# the pyramid level: 2 ulps of the largest value (2^-22); its own check counts the ulps of every value
TOL = {"K1": 1e-5, "K2": 1e-4, "K3_f32": 1e-4, "K3_bf16": 2e-2, "PE": 0.0, "PY": 2.4e-7}
PY_ULPS = 2


def py_work(prev: torch.Tensor, ksize: int, hk: int, wk: int) -> tuple[float, float]:
    """(bytes, operations) of a pyramid level of P pairs: the grey images
    read once and the level written; the smoothing's rounded products and
    adds at the points the resize reads (horizontal at every row a sampled
    row's taps reach and every sampled column, vertical at the sampled rows
    and columns, 2 k - 1 a sum of k taps), at the add rate."""
    p, h, w = prev.shape
    rows = np.unique(flow_mod._pyramid_axis(h, hk)[:, :2])
    cols = np.unique(flow_mod._pyramid_axis(w, wk)[:, :2])
    r = ksize // 2
    reach = np.zeros(h, bool)
    for y in rows:
        reach[max(0, y - r) : y + r + 1] = True
    nbytes = 2 * p * (h * w * prev.element_size() + hk * wk * 4)
    return float(nbytes), float(2 * p * (int(reach.sum()) + len(rows)) * len(cols) * (2 * ksize - 1))


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


def kernel_records(fns: list, passes: int) -> list:
    """(name, us) of every CUDA kernel record torch.profiler kept over
    ``passes`` passes over ``fns``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fns: list, per_call: int | None = 1, passes: int = 10, tries: int = 3,
              split: dict | None = None) -> float | None:
    """Summed device time of the work that the calls in ``fns`` launch, in
    ms per pass over them, from torch.profiler's CUDA activity (no host or
    launch time).

    The profiler drops kernel records: after the main path's first video,
    some of every session's, more as the process goes on.  So each call is
    profiled on its own and each kernel function it launches is timed by the
    mean of its records kept (every pass repeats the same work).  A call of
    this repo's kernels launches ``per_call`` kernels, each a different
    function: its records are counted against passes x per_call, and a call
    whose records lack one of its functions, or hold more launches than
    that, is profiled again, ``tries`` times in all, then gives None, and
    the caller quotes events.  For a library call (``per_call`` None) a
    function's launches a call are its records over the passes, rounded.
    Calls with records missing are named.  ``split``, where given, gathers
    the ms a pass by kernel function."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total, short = 0.0, []
    for i, fn in enumerate(fns):
        for _ in range(tries):
            recs = kernel_records([fn], passes)
            by_name: dict = {}
            for name, us in recs:
                by_name.setdefault(name, []).append(us)
            if per_call is None or (len(by_name) == per_call and len(recs) <= passes * per_call):
                break
        else:
            print(f"  device_ms: call {i} kept {len(recs)} kernel records of {passes * per_call} launched, of "
                  f"{len(by_name)} functions ({per_call} expected), in each of {tries} profiles: no device time "
                  f"(quote events)")
            return None
        launches = {name: 1 if per_call else max(1, round(len(v) / passes)) for name, v in by_name.items()}
        if len(recs) < passes * sum(launches.values()):
            short.append(f"{i}: {len(recs)} of {passes * sum(launches.values())}")
        total += sum(sum(v) / len(v) * launches[name] for name, v in by_name.items())
        for name, v in by_name.items():
            if split is not None:
                fn_name = (re.findall(r"\w+_kernel", name) or [name[:40]])[0]
                split[fn_name] = split.get(fn_name, 0.0) + sum(v) / len(v) * launches[name] / 1e3
    if short:
        print(f"  device_ms: the profiler dropped records of {len(short)} of {len(fns)} calls (call: records kept) "
              f"{' '.join(short)}: their functions' means of the records kept stand")
    return total / 1e3 if total > 0 else None


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


def bound(nbytes: float, flops: float, dtype, peak: float | None = None) -> tuple[float, str]:
    """The least ms the card could take: the bytes over the memory rate or
    the operations over ``peak`` (default: the data sheet's rate for
    ``dtype``), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nan_padded(t: torch.Tensor, extra: int = 4096, at: int = 0) -> torch.Tensor:
    """A contiguous copy of ``t`` ``at`` elements into a larger NaN-filled
    allocation, so a read out of bounds poisons the result (``at`` = 1: rows
    that are not 16-byte aligned, for the kernels' 4-byte paths)."""
    buf = torch.full((t.numel() + at + extra,), float("nan"), dtype=t.dtype, device=t.device)
    buf[at : at + t.numel()].copy_(t.reshape(-1))
    return buf[at : at + t.numel()].view(t.shape)


class Laps:
    """Host seconds by step: ``lap(step)`` closes the step that ran since the
    previous lap (or since the Laps was made); a step lapped again adds up."""

    def __init__(self):
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def __call__(self, step: str) -> None:
        now = time.perf_counter()
        self.seconds[step] = self.seconds.get(step, 0.0) + now - self._t
        self._t = now

    def show(self, what: str) -> None:
        print(f"  {what} seconds by step: { {k: round(v, 1) for k, v in self.seconds.items()} }")


# ------------------------------------------------------------------ phase 2
def report_build(so: str) -> dict:
    """ptxas's registers and spills for every kernel function, and the count
    of tensor-core instructions (HMMA/HGMMA) in each K3 function's SASS
    (cuobjdump from the toolkit that built them); raises if a bf16 K3
    function, short or long, has none, or if the long K3 kernels, the
    generic-radius K2 kernel, the wide-window K2's two passes, the
    polynomial expansion kernel or the pyramid kernel spill."""
    funcs = {}
    for src in ("warp.cu", "boxsolve.cu", "attention.cu", "polyexp.cu", "window_attention.cu", "pyramid.cu"):
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
        kernel = re.search(r"(update_matrices|box_blur_solve|box_ring_solve|box_vsum|box_hsum_solve|mha_bf16(_long|_ring)?"
                           r"|mha_f32(_long|_online)?|poly_expansion|window_mha|pyramid_level)_kernel", name)
        args = ",".join(re.findall(r"Li(\d+)E", name))
        f["kernel"] = f"{kernel.group(0) if kernel else name}<{args}>"
        mma = f"; {f.get('tensor_core_instructions')} HMMA/HGMMA" if "mha" in name else ""
        print(f"  {f.get('source')}: {f['kernel']}: {f.get('registers')} registers, {f.get('spill')}{mma}")
    bf16_mha = [f for n, f in funcs.items() if "mha_bf16" in n]
    if not all(any(k in n for n in funcs) for k in ("mha_bf16_long", "mha_bf16_ring", "mha_f32_online",
                                                    "box_ring_solve", "box_vsum", "box_hsum_solve",
                                                    "poly_expansion", "window_mha", "pyramid_level")):
        raise AssertionError("the long K3, the generic-radius or wide-window K2, the expansion, K4 or the pyramid "
                             "functions are missing from the build")
    for kernel in ("mha_bf16_ring", "mha_f32_online", "box_ring_solve", "box_vsum", "box_hsum_solve",
                   "poly_expansion", "pyramid_level"):
        fs = {n: f for n, f in funcs.items() if kernel in n}
        if any("0 bytes spill stores" not in f.get("spill", "") for f in fs.values()):
            raise AssertionError(f"the {kernel} kernel spills: {fs}")
    if not bf16_mha or not all(f.get("tensor_core_instructions") for f in bf16_mha):
        raise AssertionError("a bf16 K3 function has no tensor-core instructions in its SASS")
    return funcs


# ------------------------------------------------------------------ phase 3
def k2_route_counts() -> tuple:
    return box_blur_solve.launches, box_blur_solve.generic_launches, box_blur_solve.wide_launches


def check_k2_window(m: torch.Tensor, ws: int, label: str) -> float:
    """K2 at a window past the strip kernel's against its plain version:
    within ``TOL`` of max |plain|, bit-identical (both routes form the plain
    version's sums in its order), and launched on the route ``_entry``
    names; -> |kernel - plain|."""
    n0 = k2_route_counts()
    got, want = box_blur_solve(m, ws), box_blur_solve_plain(m, ws)
    err, rel = rel_err(got, want)
    check(f"K2 {label} winsize {ws}", rel, TOL["K2"], verbose=False)
    generic = boxsolve_mod._entry(ws) == boxsolve_mod._GENERIC
    if tuple(b - a for a, b in zip(n0, k2_route_counts())) != (1, int(generic), int(not generic)):
        raise AssertionError(f"K2 {label} winsize {ws} did not launch the {'generic' if generic else 'wide'} route")
    if err != 0:
        raise AssertionError(f"K2 {label} winsize {ws}: |kernel - plain| {err}, not bit-identical")
    return err


def k2_edge_widths(ws: int) -> tuple:
    """The widths at the edges of the plan of the K2 route that takes
    window ``ws``: the generic-radius kernel's widest strip (128 - 2 R4)
    less one, itself and one more; for the wide route, the same about its
    vertical strip (128 columns) and its horizontal pass's widest strip
    (whole rows up to 2,048 columns)."""
    if boxsolve_mod._entry(ws) == boxsolve_mod._GENERIC:
        strips = (boxsolve_mod.RING_SPAN - 2 * ((ws // 2 + 3) & ~3),)
    else:
        strips = (boxsolve_mod.WIDE_SPAN, 4 * boxsolve_mod.WIDE_RUNS)
    return tuple(s + d for s in strips for d in (-1, 0, 1))


def check_wide_chunks(gen: torch.Generator) -> float:
    """The wide route with both passes' taps in chunks, by a plan that
    forces them (the vertical pass's taps in launches of a third of the
    window, each adding to the scratch sums of the ones before; the
    horizontal pass's in staged chunks of about a quarter; horizontal
    strips of at most 128 columns), at winsizes 67 and 131 on the 135x240
    level with 16 pairs and on ragged shapes, aligned and offset by one
    float: bit-identical to the plain version; -> |kernel - plain|."""
    worst = 0.0
    for ws in (PAIR_WINSIZE, 131):
        for p, hk, wk in ((PAIRS, 135, 240), (1, ws - 2, 131), (2, 37, 129)):
            m = torch.randn((p, 5, hk, wk), generator=gen, device="cuda") * 50
            want = box_blur_solve_plain(m, ws)
            for at in (0, 1):
                mm = nan_padded(m, at=at)
                plan = boxsolve_mod._wide_plan(p, hk, wk, ws, boxsolve_mod._wide_slots(mm.device, ws), runs=32,
                                               vtaps=ws // 3, htaps=4 * (ws // 12))
                flow, scratch = mm.new_empty((p, 2, hk, wk)), mm.new_empty((p, 5, hk, plan[0]))
                _native.launch(boxsolve_mod._WIDE, mm.device, mm.data_ptr(), scratch.data_ptr(), flow.data_ptr(), p,
                               hk, wk, ws, *plan)
                err, _ = rel_err(flow, want)
                if err != 0:
                    raise AssertionError(f"K2 wide route, taps in chunks (plan {plan}), winsize {ws} {p}x{hk}x{wk} "
                                         f"offset {at}: |kernel - plain| {err}, not bit-identical")
                worst = max(worst, err)
    print(f"  K2 wide route with both passes' taps in chunks, winsizes {PAIR_WINSIZE} and 131, 12 checks: largest "
          f"|kernel - plain| {worst:g}")
    return worst


def check_flow_kernels(gen: torch.Generator) -> dict:
    """K1 and K2 against their plain versions at the four 540p and 1080p
    levels and the 4K finest level, with
    per-pixel random flows up to +-40 px (many corners clipped, many pixels
    outside) and NaN-padded inputs; K2 also at ragged shapes, at other odd
    windows, and at the windows past the strip kernel's largest
    (``WIDE_WINDOWS``) on the 540p levels and the ragged shapes, and, at
    each, on P = 1 at the edges of the plan of the route that takes it (W in
    1, 3, 4, ``k2_edge_widths``, 131; H 1 and below the window), aligned
    and offset by one float; the largest |kernel - plain| of every check
    printed (0: bit-identical), each launching the route ``_entry`` names;
    then the wide route with its taps in chunks (``check_wide_chunks``)."""
    worst = {"K1": 0.0, "K2": 0.0, "K2_generic": 0.0, "K2_wide": 0.0}
    shapes = [(PAIRS, hk, wk, 15) for _, hk, wk in pyramid_levels(H, W)]
    shapes += [(PAIRS, hk, wk, 15) for _, hk, wk in pyramid_levels(H_HI, W_HI)]
    shapes += [(4, 2 * H_HI, 2 * W_HI, 15), (2, H_HI, W_HI, 5), (2, H_HI, W_HI, STRIP_WINSIZE)]
    shapes += [(2, 16, 20, 15), (2, 67, 131, 15), (2, 67, 131, 5), (PAIRS, 135, 240, 5),
               (2, 67, 131, STRIP_WINSIZE), (PAIRS, 135, 240, STRIP_WINSIZE)]
    wide = {(PAIRS, hk, wk) for _, hk, wk in pyramid_levels(H, W)} | {(2, 16, 20), (2, 67, 131)}
    errs = {ws: {} for ws in WIDE_WINDOWS}  # window -> shape -> |kernel - plain|
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
        if (p, hk, wk) in wide and ws == 15:
            wide.discard((p, hk, wk))
            for wws in WIDE_WINDOWS:
                errs[wws][f"{p}x{hk}x{wk}"] = check_k2_window(m, wws, f"{p}x{hk}x{wk}")
        del r0, r1, flow, m
        torch.cuda.empty_cache()
    if wide:
        raise AssertionError(f"no K2 check at wide windows for {wide}")
    for wws in WIDE_WINDOWS:
        for hk in (1, wws - 2):
            for wk in (1, 3, 4, *k2_edge_widths(wws), 131):
                m = torch.randn((1, 5, hk, wk), generator=gen, device="cuda") * 50
                for tag, mm in (("", nan_padded(m)), (" offset", nan_padded(m, at=1))):
                    errs[wws][f"1x{hk}x{wk}{tag}"] = check_k2_window(mm, wws, f"1x{hk}x{wk}{tag}")
        route = "generic" if boxsolve_mod._entry(wws) == boxsolve_mod._GENERIC else "wide"
        worst[f"K2_{route}"] = max([worst[f"K2_{route}"], *errs[wws].values()])
        print(f"  K2 winsize {wws} ({route} route): largest |kernel - plain| {max(errs[wws].values()):g} over "
              f"{len(errs[wws])} checks; by shape (P x H x W, o: one float into the allocation): "
              + " ".join(f"{k.replace(' offset', 'o')}:{v:g}" for k, v in errs[wws].items()))
    worst["K2_wide"] = max(worst["K2_wide"], check_wide_chunks(gen))
    n0 = k2_route_counts()
    m = torch.rand((1, 5, 16, 16), device="cuda")
    for ws in (STRIP_WINSIZE, STRIP_WINSIZE + 2, GENERIC_WINSIZE, GENERIC_WINSIZE + 2):
        box_blur_solve(m, ws)
    n1 = tuple(b - a for a, b in zip(n0, k2_route_counts()))
    print(f"  K2 winsize {STRIP_WINSIZE}, {STRIP_WINSIZE + 2}, {GENERIC_WINSIZE} and {GENERIC_WINSIZE + 2}: "
          f"launches {n1[0]}, of them generic {n1[1]}, wide {n1[2]}")
    if n1 != (4, 2, 1):
        raise AssertionError(f"K2 routing: winsize {STRIP_WINSIZE} must take the strip kernel, "
                             f"{STRIP_WINSIZE + 2} and {GENERIC_WINSIZE} the generic one and "
                             f"{GENERIC_WINSIZE + 2} the pair, got (launches, generic, wide) {n1}")
    return worst


def pe_into_nan(x: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """The expansion kernel launched as ``poly_expansion`` launches it, but
    into a NaN-filled output, so an element it does not write stays NaN."""
    h, w = x.shape[-2:]
    out = torch.full((*x.shape[:-2], 5, h, w), float("nan"), device=x.device)
    images = x.numel() // (h * w)
    tw, seg, _ = flow_mod._poly_plan(images, h, w, n, flow_mod._poly_resident(x.device, n))
    _native.launch(flow_mod._POLY, x.device, x.data_ptr(), out.data_ptr(), images, h, w, n,
                   flow_mod._poly_coeffs_f32(n, sigma).ctypes.data, tw, seg)
    return out


def check_poly_expansion(gen: torch.Generator) -> float:
    """The polynomial expansion kernel against ``poly_expansion_plain`` with
    ``torch.equal``, on the same CUDA input and against the CPU: 32 images
    (16 pairs) at the four 540p and the four 1080p levels (the CPU on the
    first pair), radius 5, through the wrapper and into NaN-filled outputs;
    then at radii 1, 2, 5, 7, 9 and
    ``POLY_NMAX`` on 2 images at the edges of the plan (W 1, 3, 4, the strip
    128 - 2 n4 less one, itself and one more, 131; H 1, 2n, 35), aligned and
    one float into the allocation.  Every input sits in a NaN-filled
    allocation.  Returns the largest |kernel - plain| (0: every check
    bit-identical); raises on any difference or a wrapper call that did not
    launch once."""
    worst, checks, calls, n0 = 0.0, 0, 0, poly_expansion.launches

    def one(x: torch.Tensor, n: int, sigma: float, label: str, part) -> None:
        nonlocal worst, checks, calls
        want = poly_expansion_plain(x, n, sigma)
        want_cpu = poly_expansion_plain(part(x).cpu(), n, sigma)
        gots = [poly_expansion(x, n, sigma), pe_into_nan(x, n, sigma)]
        calls += 1
        for got in gots:
            worst = max(worst, (got - want).abs().max().item())
            if not torch.equal(got, want) or not torch.equal(part(got).cpu(), want_cpu):
                raise AssertionError(f"expansion {label} n {n}: kernel differs from its plain version "
                                     f"(|kernel - plain| {(got - want).abs().max().item()})")
            checks += 1

    for tag, (h, w) in [("540p", lv[1:]) for lv in pyramid_levels(H, W)] + \
                       [("1080p", lv[1:]) for lv in pyramid_levels(H_HI, W_HI)]:
        x = nan_padded(torch.rand((2, PAIRS, h, w), generator=gen, device="cuda") * 255)
        one(x, 5, 1.2, f"{tag} 2x{PAIRS}x{h}x{w}", lambda t: t[:, :1])
        del x
        torch.cuda.empty_cache()
    for n in (1, 2, 5, 7, 9, POLY_NMAX):
        strip = POLY_SPAN - 2 * ((n + 3) & ~3)
        for hk in (1, 2 * n, 35):
            for wk in sorted({1, 3, 4, max(strip - 1, 1), strip, strip + 1, 131}):
                x = torch.rand((2, hk, wk), generator=gen, device="cuda") * 255
                for at in (0, 1):
                    one(nan_padded(x, at=at), n, 1.2 if n == 5 else 0.3 * n, f"2x{hk}x{wk}{' +1' * at}",
                        lambda t: t)
    launched = poly_expansion.launches - n0
    print(f"  polynomial expansion: {checks} checks bit-identical to the plain version on the card and the "
          f"CPU (largest |kernel - plain| {worst:g}); the wrapper launched {launched} times in {calls} calls")
    if launched != calls:
        raise AssertionError(f"expansion wrapper: {launched} launches in {calls} calls")
    return worst


def pyramid_level_on_plain(prev: torch.Tensor, nxt: torch.Tensor, ksize: int, sigma: float, hk: int,
                           wk: int) -> torch.Tensor:
    """The plain version of a pyramid level, on the tensors' device, as
    ``pyramid_level``'s CPU route calls it."""
    base2 = torch.stack([prev, nxt]).to(torch.float32)
    return flow_mod.pyramid_level_plain(base2, flow_mod._gaussian_kernel(ksize, sigma), hk, wk)


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of the last place of want (f32)."""
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    mag = want.abs()
    spacing = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return ((got.double() - want.double()).abs() / spacing.double()).max().item()


def py_into_nan(prev: torch.Tensor, nxt: torch.Tensor, ksize: int, sigma: float, hk: int, wk: int) -> torch.Tensor:
    """The pyramid kernel launched as ``pyramid_level`` launches it, but into
    a NaN-filled output, so an element it does not write stays NaN."""
    p, h, w = prev.shape
    out = torch.full((2, p, hk, wk), float("nan"), device=prev.device)
    r, elem = ksize // 2, prev.element_size()
    smem = flow_mod._pyramid_tile(h, w, hk, wk, r, elem)[3]
    tw, seg, span, planes = flow_mod._pyramid_plan(2 * p, h, w, hk, wk, r, elem,
                                                   flow_mod._pyramid_resident(prev.device, elem, r, smem))
    _native.launch(flow_mod._PYR, prev.device, prev.data_ptr(), nxt.data_ptr(), out.data_ptr(),
                   flow_mod._pyramid_tables(h, w, hk, wk, prev.device).data_ptr(), p, h, w, hk, wk, r, elem,
                   flow_mod._pyramid_taps_f32(ksize, sigma).ctypes.data, tw, seg, span, planes)
    return out


def combined_as_the_kernel(smooth: torch.Tensor, hk: int, wk: int) -> torch.Tensor:
    """The plain smoothing (..., H, W) resized as the kernel combines it:
    rows then columns, the first weight's rounded product, then the second
    weight's product added with one rounding (exact in f64 but for a rare
    double rounding)."""
    h, w = smooth.shape[-2:]

    def axis(x, tab, dim):
        tab = torch.from_numpy(tab).to(x.device)
        i0, i1 = tab[:, 0].long(), tab[:, 1].long()
        w0, w1 = tab[:, 2].view(torch.float32), tab[:, 3].view(torch.float32)
        shape = [1] * x.dim()
        shape[dim] = -1
        w0, w1 = w0.view(shape), w1.view(shape)
        first = w0 * x.index_select(dim, i0)
        return (w1.double() * x.index_select(dim, i1).double() + first.double()).float()

    return axis(axis(smooth, flow_mod._pyramid_axis(h, hk), -2), flow_mod._pyramid_axis(w, wk), -1)


def check_pyramid_level(gen: torch.Generator) -> dict:
    """The pyramid kernel against ``pyramid_level_plain`` on the card: 16
    pairs at the four 540p and the four 1080p levels, uint8 and f32 grey
    (f32 in NaN-padded allocations), then ragged shapes (H x W 33 x 47, 70 x
    90, 131 x 67 and 48 x 64 at their levels, each at the start of its
    allocation and one element into it) and radii 4, 9, 39 and ``PYR_RMAX`` on 2 pairs of 170 x 181;
    through the wrapper and into NaN-filled outputs.  The smoothing: the
    kernel on an unchanged geometry at each level's Gaussian is
    ``torch.equal`` to the plain smoothing; the level: at most ``PY_ULPS``
    ulps from the plain level, and the ulps from the plain smoothing
    combined as the kernel combines it (expected 0).  Raises on a
    difference or a wrapper call that did not launch once."""
    res = {"checks": 0, "smoothing_checks": 0, "level_ulps": 0.0, "combined_ulps": 0.0, "max_abs_err": 0.0}
    calls, n0 = 0, pyramid_level.launches

    def padded(t: torch.Tensor, at: int) -> torch.Tensor:
        """``t`` ``at`` elements into a larger allocation (NaN-filled for f32)."""
        if t.dtype == torch.float32:
            return nan_padded(t, at=at)
        buf = torch.zeros(t.numel() + at + 4096, dtype=t.dtype, device=t.device)
        buf[at : at + t.numel()] = t.reshape(-1)
        return buf[at : at + t.numel()].view(t.shape)

    def one(prev, nxt, ksize, sigma, hk, wk, label):
        nonlocal calls
        h, w = prev.shape[-2:]
        smooth = pyramid_level(prev, nxt, ksize, sigma, h, w)
        base2 = torch.stack([prev, nxt]).to(torch.float32)
        plain_smooth = flow_mod._sep_correlate(base2, flow_mod._gaussian_kernel(ksize, sigma),
                                               flow_mod._gaussian_kernel(ksize, sigma), "reflect")
        if not torch.equal(smooth, plain_smooth):
            raise AssertionError(f"pyramid {label} ksize {ksize}: smoothing differs from the plain version "
                                 f"(|kernel - plain| {(smooth - plain_smooth).abs().max().item()})")
        res["smoothing_checks"] += 1
        want = flow_mod.resize_hw(plain_smooth, (hk, wk), "linear", antialias=False)
        as_kernel = combined_as_the_kernel(plain_smooth, hk, wk)
        del plain_smooth, smooth
        calls += 2  # the smoothing and the level through the wrapper
        for got in (pyramid_level(prev, nxt, ksize, sigma, hk, wk), py_into_nan(prev, nxt, ksize, sigma, hk, wk)):
            u = ulps(got, want)
            res["level_ulps"] = max(res["level_ulps"], u)
            res["combined_ulps"] = max(res["combined_ulps"], ulps(got, as_kernel))
            res["max_abs_err"] = max(res["max_abs_err"], (got - want).abs().max().item())
            if u > PY_ULPS:
                raise AssertionError(f"pyramid {label} ksize {ksize} -> {hk}x{wk}: {u} ulps from the plain level")
            res["checks"] += 1
        torch.cuda.empty_cache()

    def params(scale):
        sigma = (1.0 / scale - 1.0) * 0.5
        return max(flow_mod._cvround(sigma * 5) | 1, 3), sigma

    for tag, (hh, ww) in (("540p", (H, W)), ("1080p", (H_HI, W_HI))):
        for dtype in (torch.uint8, torch.float32):
            prev = torch.randint(0, 256, (PAIRS, hh, ww), generator=gen, device="cuda", dtype=torch.uint8)
            nxt = torch.randint(0, 256, (PAIRS, hh, ww), generator=gen, device="cuda", dtype=torch.uint8)
            prev, nxt = padded(prev.to(dtype), 0), padded(nxt.to(dtype), 0)
            for scale, hk, wk in pyramid_levels(hh, ww):
                one(prev, nxt, *params(scale), hk, wk, f"{tag} {PAIRS}x{hh}x{ww} {str(dtype)[6:]}")
            del prev, nxt
    for hh, ww in ((33, 47), (70, 90), (131, 67), (48, 64)):
        for dtype in (torch.uint8, torch.float32):
            for at in (0, 1):
                prev, nxt = (padded(torch.randint(0, 256, (2, hh, ww), generator=gen, device="cuda",
                                                  dtype=torch.uint8).to(dtype), at) for _ in range(2))
                for scale, hk, wk in pyramid_levels(hh, ww):
                    one(prev, nxt, *params(scale), hk, wk, f"2x{hh}x{ww} {str(dtype)[6:]}{' +1' * at}")
    for ksize, sigma, hk, wk in ((9, 1.5, 43, 45), (19, 3.5, 21, 23), (79, 15.5, 5, 6),
                                 (2 * PYR_RMAX + 1, 31.5, 3, 3)):
        for dtype in (torch.uint8, torch.float32):
            prev, nxt = (padded(torch.randint(0, 256, (2, 170, 181), generator=gen, device="cuda",
                                              dtype=torch.uint8).to(dtype), 0) for _ in range(2))
            one(prev, nxt, ksize, sigma, hk, wk, f"2x170x181 {str(dtype)[6:]}")
    launched = pyramid_level.launches - n0
    print(f"  pyramid level: {res['smoothing_checks']} smoothings bit-identical to the plain version; "
          f"{res['checks']} levels within {res['level_ulps']:g} ulps of the plain level (bound {PY_ULPS}; "
          f"{res['combined_ulps']:g} ulps from the plain smoothing combined as the kernel combines it; largest "
          f"|kernel - plain| {res['max_abs_err']:g}); the wrapper launched {launched} times")
    if launched != calls:
        raise AssertionError(f"pyramid wrapper: {launched} launches in {calls} calls")
    return res


def time_pyramid_levels() -> dict:
    """Each pyramid level of 16 uint8 grey pairs at 540p and 1080p: the
    kernel by events and by the profiler's device time, the plain version
    by events, the bound (``py_work``) and the kernel's share of it; then the
    whole flow on the same pairs with the kernel and with the plain level
    (CUDA events), the flows' largest and mean difference in px, and the
    launches of one flow call."""
    out = {}
    for tag, (hh, ww) in (("540p", (H, W)), ("1080p", (H_HI, W_HI))):
        frames = bgr_to_gray(synthetic_bgr(PAIRS + 1, hh, ww, seed=11))
        prev, nxt = frames[:-1].contiguous(), frames[1:].contiguous()
        levels = []
        for scale, hk, wk in pyramid_levels(hh, ww):
            sigma = (1.0 / scale - 1.0) * 0.5
            ksize = max(flow_mod._cvround(sigma * 5) | 1, 3)
            fn = lambda a=(prev, nxt, ksize, sigma, hk, wk): pyramid_level(*a)  # noqa: E731
            nbytes, ops = py_work(prev, ksize, hk, wk)
            bound_ms, by = bound(nbytes, ops, torch.float32, F32_ADDS_PER_S)
            lv = {"level": f"{hk}x{wk}", "ksize": ksize, "ms": cuda_ms(fn), "device_ms": device_ms([fn]),
                  "plain_ms": cuda_ms(lambda a=(prev, nxt, ksize, sigma, hk, wk): pyramid_level_on_plain(*a), iters=3),
                  "bound_ms": bound_ms, "bound_by": by}
            lv["share"] = lv["bound_ms"] / lv["device_ms"] if lv["device_ms"] else None
            levels.append(lv)
            share = "not measured" if lv["share"] is None else f"{lv['share']:.1%}"
            print(f"    {tag} level {lv['level']} (ksize {ksize}): kernel {lv['ms']:.4f} ms by events, device "
                  f"{lv['device_ms']}; plain {lv['plain_ms']:.3f} ms; bound {bound_ms:.4f} by {by}, share {share}")
        n0 = pyramid_level.launches
        got = farneback_flow(prev, nxt, **FARNEBACK_PARAMS)
        launched = pyramid_level.launches - n0
        saved = flow_mod.pyramid_level
        flow_mod.pyramid_level = pyramid_level_on_plain
        try:
            want = farneback_flow(prev, nxt, **FARNEBACK_PARAMS)
            plain_flow_ms = cuda_ms(lambda: farneback_flow(prev, nxt, **FARNEBACK_PARAMS), iters=3)
        finally:
            flow_mod.pyramid_level = saved
        err = (got - want).abs()
        r = {"levels": levels, "pyramid_launches": launched, "flow_ms": cuda_ms(
            lambda: farneback_flow(prev, nxt, **FARNEBACK_PARAMS), iters=3), "plain_flow_ms": plain_flow_ms,
            "flow_max_diff_px": err.max().item(), "flow_mean_diff_px": err.mean().item(),
            "kernel_device_ms": sum(lv["device_ms"] or math.nan for lv in levels),
            "bound_ms": sum(lv["bound_ms"] for lv in levels)}
        print(f"  pyramid {tag}, {PAIRS} pairs: the 4 levels {r['kernel_device_ms']:.4f} device ms (bound "
              f"{r['bound_ms']:.4f}); the flow {r['flow_ms']:.3f} ms with the kernel, {plain_flow_ms:.3f} with the "
              f"plain level; flows differ by {r['flow_max_diff_px']:.3e} px at most, {r['flow_mean_diff_px']:.3e} "
              f"mean; {launched} pyramid launches a flow call")
        if launched != 4:
            raise AssertionError(f"pyramid {tag}: {launched} launches a flow call, not 4")
        if not (r["flow_mean_diff_px"] <= 1e-3 and torch.isfinite(got).all()):
            raise AssertionError(f"pyramid {tag}: the flow with the kernel differs from the plain level's: {r}")
        out[tag] = r
        del prev, nxt, frames, got, want
        torch.cuda.empty_cache()
    return out


def check_attention_kernel(gen: torch.Generator) -> dict:
    """K3 in f32 and bf16 at the ViT shape and at N in {1, 17, 64, 197, 208,
    256} x D in {32, 64} (the short entries), and at N in {257, 300, 577,
    1025} x D in {32, 64, 80, 128, 256} (the long entries; D = 80 padded to
    128) and N in ``RING_EDGES`` and ``TAIL_EDGES`` x D in {32, 64} (the
    edges of the long kernels' query blocks and key tiles, and of the f32
    one-pass kernel's last key tile), on contiguous NaN-padded inputs and on column slices of a NaN-padded packed qkv
    tensor, each call launching the entry ``_plan`` names; then the long
    entry called directly at N = 197 and 256 against the short one."""
    short = [ATTN_SHAPE] + [(2, n, 3, d) for n in (1, 17, 64, 197, 208, 256) for d in (32, 64)]
    long = [(2, n, 3, d) for n in (257, 300, 577, 1025) for d in (32, 64, 80, 128, 256)]
    long += [(2, n, 3, d) for n in RING_EDGES + TAIL_EDGES for d in (32, 64)]
    # the long entries at D 32 and 64: the bf16 ring kernel, the f32 one-pass kernel
    worst = {"K3_long_bf16_ring": 0.0, "K3_long_f32_online": 0.0}
    at = {"bf16": "K3_long_bf16_ring", "f32": "K3_long_f32_online"}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        worst[f"K3_{tag}"] = worst[f"K3_long_{tag}"] = 0.0
        for b, n, h, d in short + long:
            key = f"K3_long_{tag}" if (b, n, h, d) in long else f"K3_{tag}"
            scale = d**-0.5
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
            q, k, v = (nan_padded(qkv[..., i * h * d : (i + 1) * h * d].reshape(b, n, h, d)) for i in range(3))
            want = mha_plain(q, k, v, scale)
            n0 = mha.long_launches
            err, rel = rel_err(mha(q, k, v, scale), want)
            check(f"K3 {tag} {(b, n, h, d)} contiguous", rel, TOL[f"K3_{tag}"], verbose=key == f"K3_{tag}")
            packed = nan_padded(qkv)
            qs, ks, vs = (packed[..., i * h * d : (i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
            err2, rel2 = rel_err(mha(qs, ks, vs, scale), want)
            check(f"K3 {tag} {(b, n, h, d)} packed-qkv slices", rel2, TOL[f"K3_{tag}"], verbose=key == f"K3_{tag}")
            worst[key] = max(worst[key], err, err2)
            if key == f"K3_long_{tag}" and d in attention_mod.SHORT_HEAD_DIMS:
                worst[at[tag]] = max(worst[at[tag]], err, err2)
            entry, _ = attention_mod._plan(n, d, dtype)
            if mha.long_launches - n0 != (2 if entry == attention_mod._LONG[dtype] else 0):
                raise AssertionError(f"K3 {tag} {(b, n, h, d)}: not the entry _plan names ({entry})")
        print(f"  K3 {tag} long entries at N in (257, 300, 577, 1025) x D in (32, 64, 80, 128, 256) and N in "
              f"{RING_EDGES + TAIL_EDGES} x D in (32, 64): largest |kernel - plain| {worst[f'K3_long_{tag}']:.3e}"
              + f" (the {'ring' if tag == 'bf16' else 'one-pass'} kernel, D 32 and 64: {worst[at[tag]]:.3e})"
              + f", every call within {TOL[f'K3_{tag}']:.0e} of max |plain|")
        for n in (197, 256):
            for d in (32, 64):
                q, k, v = (nan_padded(torch.randn((2, n, 3, d), generator=gen, device="cuda").to(dtype))
                           for _ in range(3))
                short_o = mha(q, k, v, d**-0.5)
                long_o = attention_mod._launch(q, k, v, d**-0.5, attention_mod._LONG[dtype])
                err, rel = rel_err(long_o, short_o)
                check(f"K3 {tag} long entry against the short one at {(2, n, 3, d)}", rel, TOL[f"K3_{tag}"])
                worst[f"K3_long_{tag}"] = max(worst[f"K3_long_{tag}"], err)
    return worst


def record_kernel_inputs(run) -> dict:
    """``run()`` (one more video or batch) with the kernels' wrappers wrapped
    where the pipeline calls them, keeping every call's inputs."""
    calls = {"K1": [], "K2": [], "K3": [], "PE": [], "PY": []}
    saved = (flow_mod.update_matrices, flow_mod.box_blur_solve, vit_mod.mha, flow_mod.poly_expansion,
             flow_mod.pyramid_level)

    def keep(key, fn):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    flow_mod.update_matrices = keep("K1", update_matrices)
    flow_mod.box_blur_solve = keep("K2", box_blur_solve)
    vit_mod.mha = keep("K3", mha)
    flow_mod.poly_expansion = keep("PE", poly_expansion)
    flow_mod.pyramid_level = keep("PY", pyramid_level)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        (flow_mod.update_matrices, flow_mod.box_blur_solve, vit_mod.mha, flow_mod.poly_expansion,
         flow_mod.pyramid_level) = saved
    return calls


def time_on_main_path_inputs(calls: dict, tag: str, label: str = "main-path", verbose: bool = True) -> dict:
    """Per video (or batch): kernel, plain version (and SDPA for K3) timed on each
    recorded call and summed, by CUDA events around repeated calls (``ms``)
    and, for the kernel and SDPA, by the profiler's device durations alone
    (``device_ms``); the kernel held against the plain version on those
    inputs; the bound from those inputs' sizes."""
    kernel = {"K1": update_matrices, "K2": box_blur_solve, "K3": mha, "PE": poly_expansion, "PY": pyramid_level}
    plain = {"K1": update_matrices_plain, "K2": box_blur_solve_plain, "K3": mha_plain, "PE": poly_expansion_plain,
             "PY": pyramid_level_on_plain}
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
            if key == "PE" and not torch.equal(got, want):
                raise AssertionError(f"PE {tag} {label} call {tuple(args[0].shape)}: not bit-identical")
            if key == "PY" and ulps(got, want) > PY_ULPS:
                raise AssertionError(f"PY {tag} {label} call {tuple(args[0].shape)} -> {args[4:]}: "
                                     f"{ulps(got, want)} ulps from the plain version")
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
            elif key == "PE":
                px = args[0].numel()
                r["bytes"] += px * 6 * 4
                r["flops"] += px * pe_flops_per_px(args[1])
            elif key == "PY":
                nbytes, ops = py_work(args[0], args[2], args[4], args[5])
                r["bytes"] += nbytes
                r["flops"] += ops
            else:
                px = args[0].shape[0] * args[0].shape[-2] * args[0].shape[-1]
                r["bytes"] += px * (17 if key == "K1" else 7) * 4
                r["flops"] += px * (K1_FLOPS_PER_PX if key == "K1" else
                                    k2_flops_per_px(kwargs.get("winsize", args[1] if len(args) > 1 else 15)))
        r["bound_ms"], r["bound_by"] = bound(
            r["bytes"], r["flops"], args[0].dtype, F32_ADDS_PER_S if key in ("K2", "PE", "PY") else None)
        r["device_ms"] = device_ms(kernel_fns)
        r["library_device_ms"] = device_ms(library_fns, per_call=None) if library_fns else None
        share = f"{r['bound_ms'] / r['device_ms']:.1%}" if r["device_ms"] else "not measured"
        print(f"  {key} {tag} {label}: {r['calls']} calls (largest error / max |plain| {r['rel']:.3e}), "
              f"{r['ms']:.4f} ms "
              f"(device only {r['device_ms']}; plain {r['plain_ms']:.4f}; library {r['library_ms']}, "
              f"device only {r['library_device_ms']}; bound {r['bound_ms']:.4f} by {r['bound_by']}, "
              f"{share} of device ms)")
        out[key] = r
    return out


# ------------------------------------------------------------ phases 4 and 5
def seeded_states(vit_depth: int) -> tuple[dict, dict]:
    return (random_init_(ResNet50(), 0).state_dict(),
            random_init_(ViT(depth=vit_depth), 1).state_dict())


def synthetic_bgr(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    """(n, h, w, 3) uint8 on the device: a blurred random texture panned
    smoothly (a few px per frame, inside the band of the JAX package's
    banded warp) plus noise."""
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
    return torch.stack(out)


def bgr_to_i420(bgr: torch.Tensor) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR (on any device) -> packed I420 (n, h*w*3/2)
    numpy, BT.601 limited."""
    b, g, r = bgr.float().unbind(-1)
    y = 0.257 * r + 0.504 * g + 0.098 * b + 16.0
    u = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
    v = 0.439 * r - 0.368 * g - 0.071 * b + 128.0
    sub = lambda c: (c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]) * 0.25  # noqa: E731
    u8 = lambda c: c.round().clamp(0, 255).to(torch.uint8).reshape(len(bgr), -1)  # noqa: E731
    return torch.cat([u8(y), u8(sub(u)), u8(sub(v))], dim=1).cpu().numpy()


def segment_cosines(a: np.ndarray, b: np.ndarray) -> dict:
    out = {}
    for name, sl in segment_slices().items():
        x, y = a[sl].astype(np.float64), b[sl].astype(np.float64)
        out[name] = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-30))
    return out


def check_cuda_vs_cpu() -> dict:
    rs, vs = seeded_states(vit_depth=2)
    frames = synthetic_bgr(4, 240, 320, seed=5).cpu().numpy()
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


def slice_counts() -> dict:
    """The launches of the entries the later slices added, a part of
    ``counts()``'s: the generic-radius K2 (winsize 19 and 21), the pair of
    K2 kernels above it, and the long K3 (N > 256 or D not 32 or 64)."""
    return {"K2_generic": box_blur_solve.generic_launches, "K2_wide": box_blur_solve.wide_launches,
            "K3_long": mha.long_launches}


def reset_counts() -> None:
    update_matrices.launches = box_blur_solve.launches = mha.launches = poly_expansion.launches = 0
    pyramid_level.launches = 0
    box_blur_solve.generic_launches = box_blur_solve.wide_launches = mha.long_launches = 0


def time_k2_wide(recorded: list, winsize: int) -> dict:
    """K2 at ``winsize`` (past the strip kernel's largest) on the main path's
    recorded M planes beside the strip kernel at the recorded window, summed
    over the calls and by pyramid level (its three calls): ms by events,
    device ms by the profiler (``device_ms``: each call profiled on its own,
    its kernel records counted; and by kernel function), the plain
    version's ms, the kernel held against its plain version, and its bound
    (K2's operations are adds, at ``F32_ADDS_PER_S``).  At the small levels a call's
    events time the host's wrapper, not the device."""
    r = {"calls": len(recorded), "err": 0.0, "rel": 0.0, "ms": 0.0, "plain_ms": 0.0, "strip_ms": 0.0,
         "bytes": 0.0, "flops": 0.0, "library_ms": None, "levels": {}}
    per_call = 2 if boxsolve_mod._entry(winsize) == boxsolve_mod._WIDE else 1
    by_level = {}
    for args, kwargs in recorded:
        m, ws = args[0], kwargs.get("winsize", args[1] if len(args) > 1 else 15)
        err, rel = rel_err(box_blur_solve(m, winsize), box_blur_solve_plain(m, winsize))
        check(f"K2 winsize {winsize} on main-path input {tuple(m.shape)}", rel, TOL["K2"], verbose=False)
        r["err"], r["rel"] = max(r["err"], err), max(r["rel"], rel)
        fn, strip_fn = (lambda m=m: box_blur_solve(m, winsize)), (lambda m=m, ws=ws: box_blur_solve(m, ws))
        ms, strip_ms = cuda_ms(fn), cuda_ms(strip_fn)
        r["ms"] += ms
        r["strip_ms"] += strip_ms
        r["plain_ms"] += cuda_ms(lambda m=m: box_blur_solve_plain(m, winsize), iters=5)
        px = m.shape[0] * m.shape[-2] * m.shape[-1]
        r["bytes"] += px * 7 * 4
        r["flops"] += px * k2_flops_per_px(winsize)
        lv = by_level.setdefault("x".join(map(str, m.shape)), {"calls": 0, "ms": 0.0, "strip_ms": 0.0,
                                                              "fns": [], "strip_fns": []})
        lv["calls"] += 1
        lv["ms"] += ms
        lv["strip_ms"] += strip_ms
        lv["fns"].append(fn)
        lv["strip_fns"].append(strip_fn)
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["flops"], torch.float32, F32_ADDS_PER_S)
    for shape, lv in by_level.items():
        lv["by_function"] = {}
        lv["device_ms"] = device_ms(lv.pop("fns"), per_call=per_call, split=lv["by_function"])
        lv["strip_device_ms"] = device_ms(lv.pop("strip_fns"))
        r["levels"][shape] = lv
        print(f"    level {shape}: {lv['calls']} calls, {lv['ms']:.4f} ms by events, device only "
              f"{lv['device_ms']} (by function { {k: round(v, 4) for k, v in lv['by_function'].items()} }); the "
              f"strip kernel at the recorded window {lv['strip_ms']:.4f}, device only {lv['strip_device_ms']}")
    for key in ("device_ms", "strip_device_ms"):  # the levels' sums
        r[key] = None if any(lv[key] is None for lv in r["levels"].values()) else sum(
            lv[key] for lv in r["levels"].values())
    r["by_function"] = {}
    for lv in r["levels"].values():
        for k, v in lv["by_function"].items():
            r["by_function"][k] = r["by_function"].get(k, 0.0) + v
    share = f"{r['bound_ms'] / r['device_ms']:.1%}" if r["device_ms"] else "not measured"
    print(f"  K2 winsize {winsize} ({'wide' if per_call == 2 else 'generic'} route) on the {r['calls']} main-path "
          f"inputs: {r['ms']:.4f} ms by events (device only {r['device_ms']}; plain {r['plain_ms']:.4f}; bound "
          f"{r['bound_ms']:.4f} by {r['bound_by']}, {share} of device ms; largest error / max |plain| "
          f"{r['rel']:.3e}; by function { {k: round(v, 4) for k, v in r['by_function'].items()} }); the strip "
          f"kernel at the recorded window {r['strip_ms']:.4f} ms (device only {r['strip_device_ms']})")
    return r


def time_long_attention(gen: torch.Generator) -> dict:
    """The long K3 entries at ViT-B/16's 384x384 shape (``LONG_ATTN_SHAPE``)
    and, for the record, at the main path's 224x224 shape beside the short
    entry; SDPA on the same inputs as the library yardstick."""
    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for shape in (LONG_ATTN_SHAPE, ATTN_SHAPE):
            b, n, h, d = shape
            scale = d**-0.5
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def long_fn():
                return attention_mod._launch(q, k, v, scale, attention_mod._LONG[dtype])

            def sdpa_fn():
                return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

            err, rel = rel_err(long_fn(), mha_plain(q, k, v, scale))
            check(f"K3 long {tag} {shape}", rel, TOL[f"K3_{tag}"])
            r = {"err": err, "rel": rel, "ms": cuda_ms(long_fn), "device_ms": device_ms([long_fn]),
                 "plain_ms": cuda_ms(lambda: mha_plain(q, k, v, scale), iters=5),
                 "library_ms": cuda_ms(sdpa_fn), "library_device_ms": device_ms([sdpa_fn], per_call=None)}
            r["bound_ms"], r["bound_by"] = bound(4.0 * b * n * h * d * q.element_size(), 4.0 * b * h * n * n * d, dtype)
            if n <= attention_mod.SHORT_TOKENS:
                r["short_ms"] = cuda_ms(lambda: mha(q, k, v, scale))
                r["short_device_ms"] = device_ms([lambda: mha(q, k, v, scale)])
            print(f"  K3 long {tag} {shape}: {r['ms']:.4f} ms (device only {r['device_ms']}; plain "
                  f"{r['plain_ms']:.4f}; SDPA {r['library_ms']:.4f}, device only {r['library_device_ms']}; "
                  f"bound {r['bound_ms']:.4f} by {r['bound_by']})"
                  + (f"; the short entry {r['short_ms']:.4f} ms, device only {r['short_device_ms']}"
                     if "short_ms" in r else ""))
            out[f"{tag}_{n}"] = r
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return out


def check_wide_flow(winsize: int) -> dict:
    """``farneback_flow`` at ``winsize`` (past the strip kernel's largest) on
    2 pairs of the main path's 540p clip, CUDA against CPU, with the launches
    of the CUDA run (the path of the K2 route that takes the window) and its
    ms beside winsize 15."""
    gray = bgr_to_gray(synthetic_bgr(4, H, W, seed=7))
    prev, nxt = gray[0::2].contiguous(), gray[1::2].contiguous()
    params = dict(FARNEBACK_PARAMS, winsize=winsize)
    reset_counts()
    got = farneback_flow(prev, nxt, **params)
    torch.cuda.synchronize()
    n = counts() | slice_counts()
    want = farneback_flow(prev.cpu(), nxt.cpu(), **params)
    err = (got.cpu() - want).abs()
    out = {"launches": n, "mean_err_px": err.mean().item(), "p99_err_px": err.quantile(0.99).item(),
           "max_err_px": err.max().item(), "max_abs_flow_px": want.abs().max().item(),
           "ms": cuda_ms(lambda: farneback_flow(prev, nxt, **params), iters=5),
           "ms_winsize_15": cuda_ms(lambda: farneback_flow(prev, nxt, **FARNEBACK_PARAMS), iters=5)}
    print(f"  farneback_flow winsize {winsize}, 2 pairs at {H}x{W}: CUDA vs CPU mean {out['mean_err_px']:.3e} "
          f"px, p99 {out['p99_err_px']:.3e}, max {out['max_err_px']:.3e} (bounds 1e-3, 1e-2: 5x inside the "
          f"0.05 px cv2 tolerance; largest |flow| {out['max_abs_flow_px']:.2f} px); launches {n}; "
          f"{out['ms']:.3f} ms (winsize 15: {out['ms_winsize_15']:.3f})")
    generic = boxsolve_mod._entry(winsize) == boxsolve_mod._GENERIC
    want_n = {"K1": 12, "K2": 12, "K3": 0, "K2_generic": 12 * generic, "K2_wide": 12 * (not generic),
              "K3_long": 0}
    if n != want_n:
        raise AssertionError(f"wide-window flow: expected launches {want_n}, got {n}")
    if not (out["mean_err_px"] <= 1e-3 and out["p99_err_px"] <= 1e-2) or not torch.isfinite(got).all():
        raise AssertionError(f"wide-window flow: CUDA differs from CPU: {out}")
    return out


def run_main_path() -> dict:
    lap = Laps()
    os.makedirs(WORK_DIR, exist_ok=True)
    clip = os.path.join(WORK_DIR, "clip540p.yuv")
    bgr_to_i420(synthetic_bgr(32, H, W, seed=7)).tofile(clip)
    rs, vs = seeded_states(vit_depth=12)
    mlp_state = random_init_(Mlp(), 2).state_dict()
    scaler = FeatureScaler(fill=np.zeros(1), scale=np.ones(1), offset=np.zeros(1))
    fbuf, nbuf, h, w = decode_video_inputs_i420(clip, 4.0, W, H)
    if (len(fbuf), len(nbuf)) != (FRAMES, PAIRS):
        raise AssertionError(f"expected {FRAMES} frames and {PAIRS} pairs, got {len(fbuf)}, {len(nbuf)}")
    out = {"seconds": lap.seconds}
    lap("clip and weights")
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        fx = FeatureExtractor(rs, vs, dtype=dtype, vit_depth=12, device="cuda")
        pred = VideoQualityPredictor(fx, mlp_state, scaler)
        reset_counts()
        mos = pred.predict_file(clip, framerate=4.0, width=W, height=H)
        n = counts()
        lap(f"{tag} first video")
        print(f"  {tag}: MOS {mos!r}, launches per video {n}, of the expansion {poly_expansion.launches}, of the "
              f"pyramid {pyramid_level.launches}")
        if not math.isfinite(mos):
            raise AssertionError(f"{tag} MOS is not finite: {mos}")
        if n != {"K1": 12, "K2": 12, "K3": 12} or any(slice_counts().values()):
            raise AssertionError(f"{tag}: expected 12 launches of each kernel on the short K3 and the strip "
                                 f"K2, got {n}, of them {slice_counts()}")
        if poly_expansion.launches != 4:
            raise AssertionError(f"{tag}: expected 4 launches of the expansion (one a pyramid level), got "
                                 f"{poly_expansion.launches}")
        if pyramid_level.launches != 4:
            raise AssertionError(f"{tag}: expected 4 launches of the pyramid kernel (one a level), got "
                                 f"{pyramid_level.launches}")
        pe_launches, py_launches = poly_expansion.launches, pyramid_level.launches
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
        lap(f"{tag} warm videos")
        calls = record_kernel_inputs(lambda: pred.predict_file(clip, framerate=4.0, width=W, height=H))
        kernels = time_on_main_path_inputs(calls, tag)
        lap(f"{tag} kernels on the recorded inputs")
        out[tag] = {
            "mos": mos, "launches": n, "pe_launches": pe_launches, "py_launches": py_launches,
            "warm_ms_median": statistics.median(times),
            "warm_ms": times, "max_memory_allocated": peak, "kernels": kernels, "vec": vec,
        }
        if tag == "bf16":
            out[tag]["k2_generic"] = time_k2_wide(calls["K2"], WIDE_WINSIZE)
            out[tag]["k2_wide"] = time_k2_wide(calls["K2"], PAIR_WINSIZE)
            lap("bf16 generic and wide K2 on the recorded inputs")
        del fx, pred, kernels, calls
        torch.cuda.empty_cache()
    lap.show("phase 5")
    vec_f32 = out["f32"].pop("vec")
    cos = segment_cosines(out["bf16"].pop("vec"), vec_f32)
    out["bf16_vs_f32_cosine"] = cos
    for name, c in cos.items():
        print(f"  {name}: cosine(bf16, f32) = {c:.8f} (bound 0.9999)")
        if not c >= 0.9999:
            raise AssertionError(f"bf16 vector drifts from f32 on {name}: {c}")
    return out, vec_f32


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


def decode_540p(path: str):
    """``predict-batch``'s decode of a 540p raw clip at 4 fps (on a host
    without the native decoder: the numpy reader's I420)."""
    return decode_video(path, 4.0, W, H)


def make_clip(name: str, n: int, h: int, w: int, seed: int) -> str:
    path = os.path.join(WORK_DIR, name)
    bgr_to_i420(synthetic_bgr(n, h, w, seed=seed)).tofile(path)
    return path


def run_serving() -> tuple[dict, list]:
    """Phase 6 -> its record and the four clips' bf16 streamed vectors."""
    lap = Laps()
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
    out = {"seconds": lap.seconds}
    lap("clips and weights")
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        fx = FeatureExtractor(rs, vs, dtype=dtype, vit_depth=12, device="cuda")
        pred = VideoQualityPredictor(fx, mlp_state, scaler)
        r = out[tag] = {"backbone_peak_172": backbone_peak(fx, n_images)}
        single = [fx.video_feature_i420(f, n, h, w) for f, n, h, w in decoded]
        lap(f"{tag} backbone peak and single vectors")
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
        lap(f"{tag} a")

        print(f"  ({tag}) (b) streaming through enqueue_file, 2 in flight")
        reset_counts()
        streamed = stream(pred, clips)
        if tag == "bf16":
            streamed_bf16 = streamed
        r["stream_launches"] = check_counts(f"{tag} streaming", {k: 12 * len(clips) for k in ("K1", "K2", "K3")})
        r["stream_vs_single"] = [check_cosines(f"{tag} streamed video {i} vs single", v, s, 0.99999)
                                 for i, (v, s) in enumerate(zip(streamed, single))]
        lap(f"{tag} b")

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
        print(f"  {tag} 1080p chunked: expansion launches {poly_expansion.launches} (expected {4 * n_chunks})")
        if poly_expansion.launches != 4 * n_chunks or pyramid_level.launches != 4 * n_chunks:
            raise AssertionError(f"{tag} 1080p chunked: expected {4 * n_chunks} expansion and pyramid launches "
                                 f"(4 levels a chunk), got {poly_expansion.launches} and {pyramid_level.launches}")
        reset_counts()
        with no_sync():
            vec_whole = fx.video_features_batch_i420([fbuf_hi], [nbuf_hi], H_HI, W_HI, chunk=0)
        vec_whole = vec_whole.cpu().numpy()[0]
        r["unchunked_launches"] = check_counts(f"{tag} 1080p unchunked", {"K1": 12, "K2": 12, "K3": 12})
        r["chunked_vs_unchunked"] = check_cosines(f"{tag} 1080p chunked vs unchunked", vec_hi, vec_whole,
                                                  COS_BOUND[tag])
        lap(f"{tag} c")

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
            lap(f"{tag} d")

            print(f"  ({tag}) warm ms per video: one after the other, streamed (2 in flight), batched by 4")
            modes = {
                "sequential": lambda: [pred.predict_file(c, framerate=4.0, width=W, height=H) for c in clips],
                "streamed": lambda: predict_batch(pred, clips, decode_540p, batch=1),
                "batched": lambda: predict_batch(pred, clips, decode_540p, batch=len(clips)),
                # twelve videos: the pipeline's fill (first decode) and drain
                # (last fetch) weigh a third as much a video as with four
                "streamed_12": lambda: predict_batch(pred, clips * 3, decode_540p, batch=1),
                "batched_12": lambda: predict_batch(pred, clips * 3, decode_540p, batch=len(clips)),
                "1080p_chunked": lambda: pred.predict_file(clip_hi, framerate=4.0, width=W_HI, height=H_HI),
            }
            r["timing"] = {}
            for mode, run in modes.items():
                t = r["timing"][mode] = timed(run)
                per = {"1080p_chunked": 1, "streamed_12": 3 * len(clips), "batched_12": 3 * len(clips)}.get(
                    mode, len(clips))
                print(f"  {mode}: {t['ms_median'] / per:.2f} ms per video (runs {t['ms']} for {per}), "
                      f"busy share {t['busy_share']}, max_memory_allocated {t['max_memory_allocated']}")
            lap(f"{tag} warm timing")
            r["stages"] = {}
            for mode in ("sequential", "batched", "1080p_chunked"):
                print(f"  ({tag}) where the device time goes: {mode}")
                r["stages"][mode] = stage_breakdown(fx, modes[mode])
            lap(f"{tag} stage breakdown")

        print(f"  ({tag}) kernels on the serving shapes")
        r["kernels"] = {
            "batched_540p_v4": time_on_main_path_inputs(
                record_kernel_inputs(lambda: fx.video_features_batch_i420(*batch_args)), tag, "batched", False),
            "chunked_1080p": time_on_main_path_inputs(
                record_kernel_inputs(lambda: fx.video_feature_async_i420(fbuf_hi, nbuf_hi, H_HI, W_HI)),
                tag, "1080p", False),
        }
        lap(f"{tag} kernels on the serving shapes")
        del fx, pred
        torch.cuda.empty_cache()
    lap.show("phase 6")
    return out, streamed_bf16


# ------------------------------------------------------------------ phase 7
TRAIN_DEVICE = "cuda"
TRAIN_DIR = os.path.join(WORK_DIR, "train")
FEAT_D = TOTAL_FEATURE_DIM
KONVID_N = 1200                      # KoNViD-1k: 1,200 videos, MOS 1-5
LSVQ_TRAIN_N, LSVQ_TEST_N = 28056, 7400  # LSVQ's train and test splits (Ying et al., CVPR 2021)
LATENT = 16
SRCC_MIN = 0.8  # (a)'s floor; scripts/torch_train_rehearsal.py gives 0.978 (width 2,048) and 0.983 (8,192) on a CPU
TRAIN_TOL = dict(rtol=2e-3, atol=2e-4)
HEAD_STEPS = 40                      # steps of the step-time measurement


def host_ram_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def peak_rss_bytes() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def synthetic_features(n: int, seed: int, chunk: int = 2048) -> tuple[np.ndarray, np.ndarray]:
    """(n, FEAT_D) f32 features ``z @ A + 0.1 noise`` and MOS in 1-5, a
    monotone function of z plus noise, made on the device.  ``A`` and the
    score direction are shared by every dataset (seed 100), z and the
    noise come from ``seed``."""
    shared = torch.Generator(device=TRAIN_DEVICE).manual_seed(100)
    a = torch.randn((LATENT, FEAT_D), generator=shared, device=TRAIN_DEVICE)
    w = torch.randn((LATENT,), generator=shared, device=TRAIN_DEVICE) / LATENT**0.5
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(seed)
    x = np.empty((n, FEAT_D), np.float32)
    mos = np.empty(n)
    for i in range(0, n, chunk):
        z = torch.randn((min(chunk, n - i), LATENT), generator=gen, device=TRAIN_DEVICE)
        x[i : i + len(z)] = (z @ a + 0.1 * torch.randn((len(z), FEAT_D), generator=gen,
                                                      device=TRAIN_DEVICE)).cpu().numpy()
        score = torch.tanh(z @ w) + 0.1 * torch.randn(len(z), generator=gen, device=TRAIN_DEVICE)
        mos[i : i + len(z)] = (3 + 1.8 * score.clamp(-1.1, 1.1)).double().cpu().numpy()
    r = np.random.default_rng(seed)
    for bad in (np.nan, np.inf, -np.inf):
        x[r.integers(0, n, 3), r.integers(0, FEAT_D, 3)] = bad
    return x, mos


def write_meta(path: str, prefix: str, mos: np.ndarray) -> str:
    with open(path, "w") as f:
        f.write("vid,mos,framerate\n")
        f.writelines(f"{prefix}{i},{float(m)!r},24.0\n" for i, m in enumerate(mos))
    return path


class Timers:
    """Host seconds and calls of the wrapped functions, by label."""

    def __init__(self):
        self.s = collections.defaultdict(float)
        self.n = collections.Counter()

    def wrap(self, label: str, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[label] += time.perf_counter() - t0
                self.n[label] += 1
        return wrapped

    def report(self, wall_s: float) -> dict:
        out = {k: {"s": v, "calls": self.n[k]} for k, v in self.s.items()}
        out["wall_s"] = wall_s
        out["other_s"] = wall_s - sum(self.s.values())
        return out


# (owner, attribute, label) of the host-timed pieces of a training run; none
# calls another, so their times add up
TIMED = [(train_mod.MlpTrainer, "train_epoch", "epochs"), (train_mod.MlpTrainer, "evaluate_loss", "evaluate"),
         (train_mod, "compute_correlation_metrics", "curve_fit"),
         (protocol_mod, "preprocess_like_reference", "preprocess"), (cli, "_load_features", "load"),
         (train_mod.MlpTrainer, "init_state", "init"), (train_mod.MlpTrainer, "train_model", "init"),
         (train_mod.MlpTrainer, "update_bn", "update_bn"), (train_mod.MlpTrainer, "predict", "predict")]


@contextlib.contextmanager
def training_instruments(profile_epoch: int = 2):
    """While inside: every ``MlpTrainer.epoch_steps`` runs under ``no_sync``
    between two CUDA events; the pieces in ``TIMED`` (preprocessing,
    epochs with their fetch, per-epoch evaluation and its ``curve_fit``,
    ...) are timed on the host clock; epoch ``profile_epoch`` runs under
    the profiler (its busy share)."""
    timers, epochs, busy = Timers(), [], {}
    steps_fn = train_mod.MlpTrainer.epoch_steps
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in TIMED]

    def guarded_steps(self, model, opt, x, y, perm, gen):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with no_sync():
            start.record()
            out = steps_fn(self, model, opt, x, y, perm, gen)
            end.record()
        epochs.append((start, end, -(-len(perm) // self.cfg.batch_size)))
        return out

    def profiled(epoch_fn):
        def epoch(self, *args):
            if len(epochs) != profile_epoch:
                return epoch_fn(self, *args)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = epoch_fn(self, *args)
                wall = (time.perf_counter() - t0) * 1e3
            kernel = sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.name.startswith(("Memcpy", "Memset"))) / 1e3
            busy.update(epoch_wall_ms=wall, kernel_ms=kernel, busy_share=kernel / wall if kernel else None)
            return out
        return epoch

    train_mod.MlpTrainer.epoch_steps = guarded_steps
    for (owner, attr, label), (_, _, fn) in zip(TIMED, saved):
        setattr(owner, attr, timers.wrap(label, profiled(fn) if attr == "train_epoch" else fn))
    try:
        yield timers, epochs, busy
    finally:
        train_mod.MlpTrainer.epoch_steps = steps_fn
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def run_cli(argv: list, what: str, profile_epoch: int = 2) -> dict:
    """``cli.main(argv)`` in-process under ``training_instruments`` -> its
    JSON result line, wall-time split, per-epoch step times and busy share."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with training_instruments(profile_epoch) as (timers, epochs, busy), contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    ms = [(s.elapsed_time(e), n) for s, e, n in epochs]
    r = {"result": result, "time": timers.report(wall), "epochs": len(ms), "profiled_epoch": busy,
         "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(f"  {what}: {json.dumps(result)}")
    line = f"  {what}: wall {wall:.2f} s"
    if ms:
        r.update(epoch_ms_median=statistics.median(m for m, _ in ms), steps_per_epoch=ms[0][1],
                 step_ms_median=statistics.median(m / n for m, n in ms))
        line += (f"; {len(ms)} epochs of {r['steps_per_epoch']} steps, median {r['epoch_ms_median']:.3f} ms "
                 f"an epoch, {r['step_ms_median']:.4f} ms a step by events")
    for k, v in r["time"].items():
        if isinstance(v, dict):
            line += f"; {k} {v['s']:.2f} s ({v['calls']} calls)"
    print(line + f"; other {r['time']['other_s']:.2f} s; profiled epoch {busy}; "
          f"max_memory_allocated {r['max_memory_allocated']}")
    return r


def head_step_bound(bs: int = 256, d: int = FEAT_D, hid: int = 256) -> dict:
    """Least time of one SGD step of the head, f32 without tensor cores.
    Operations: the products of fc1 (forward, weight gradient), fc2 and fc3
    (forward, weight and input gradients).  Bytes: the batch read once, the
    parameters and the momentum buffers read once and written once."""
    h2 = hid // 2
    flops = 2 * bs * (2 * d * hid + 3 * hid * h2 + 3 * h2)
    n_params = d * hid + hid + 2 * hid + hid * h2 + h2 + h2 + 1
    nbytes = 4 * (bs * d + bs + 4 * n_params)
    ms, by = bound(nbytes, flops, torch.float32)
    return {"flops": flops, "bytes": nbytes, "bound_ms": ms, "bound_by": by}


def head_step_time(trainer: train_mod.MlpTrainer) -> dict:
    """ms of one training step at batch 256 (BN, SGD, dropout 0.1) over
    ``HEAD_STEPS`` steps: CUDA events around the steps (under ``no_sync``),
    and the profiler's device time of their kernels, its launches a step
    and its busiest ops."""
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(3)
    model = trainer.train_model(trainer.init_state(gen))
    opt = train_mod.make_optimizer(trainer.cfg, model.parameters())
    bs = trainer.cfg.batch_size
    x = torch.rand((HEAD_STEPS * bs, FEAT_D), generator=gen, device=TRAIN_DEVICE)
    y = 1 + 4 * torch.rand(HEAD_STEPS * bs, generator=gen, device=TRAIN_DEVICE)
    batches = [(x[i * bs : (i + 1) * bs], y[i * bs : (i + 1) * bs]) for i in range(HEAD_STEPS)]

    def steps():
        for xb, yb in batches:
            trainer.step(model, opt, xb, yb, gen)

    steps()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with no_sync():
        t0 = time.perf_counter()
        start.record()
        steps()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ev_ms = start.elapsed_time(end) / HEAD_STEPS
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    r = {"ms_events": ev_ms, "host_enqueue_ms": host_ms / HEAD_STEPS, "device_ms": dev_ms / HEAD_STEPS,
         "launches_per_step": len(kernels) / HEAD_STEPS, "busy_share": dev_ms / wall,
         "top_ops": [(e.key, e.self_device_time_total / 1e3 / HEAD_STEPS, e.count // HEAD_STEPS)
                     for e in ops[:8]], **head_step_bound(bs)}
    r["share_of_bound"] = r["bound_ms"] / r["ms_events"]
    print(f"  step at batch {bs}: {ev_ms:.4f} ms by events ({r['host_enqueue_ms']:.4f} ms of host enqueue), "
          f"{r['device_ms']:.4f} ms device time in {r['launches_per_step']:.1f} kernels, busy share "
          f"{r['busy_share']:.3f}; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e9:.3f} GB) = {r['share_of_bound']:.1%} of it")
    print(f"  busiest ops, device ms a step (calls a step): "
          f"{[(k, round(v, 4), c) for k, v, c in r['top_ops']]}")
    return r


def cuda_vs_cpu_training(meta: dict, x: np.ndarray) -> dict:
    """The first fold of (a)'s first repeat, 2 epochs, dropout 0, SWA off,
    from one CPU init with the same permutations, on the card and on the
    CPU: parameters, BN buffers and epoch losses within ``TRAIN_TOL``; for
    (a)'s head (BN, lr 0.1) and for (c)'s (no BN, lr 1e-2, weight decay
    5e-4)."""
    x_tr, y_tr, _, _, _ = split_other(meta, x, 0.2, math.ceil(8.8))
    x_tr, y_tr, _ = protocol_mod.preprocess_like_reference(x_tr, y_tr)
    tr_idx, _ = kfold_split(len(x_tr), 10, 42)[0]
    x_tr, y_tr = x_tr[tr_idx], y_tr[tr_idx]
    perms = [np.random.default_rng(6).permutation(len(x_tr)) for _ in range(2)]
    out = {"rows": len(x_tr)}
    for name, kw in (("bn", {}), ("no_bn", dict(use_bn=False, initial_lr=1e-2, weight_decay=5e-4))):
        cfg = train_mod.TrainConfig(drop_rate=0.0, use_swa=False, epochs=2, **kw)
        init = train_mod.state_of(flax_init_(Mlp(FEAT_D, cfg.hidden_features, drop_rate=0.0, use_bn=cfg.use_bn),
                                             torch.Generator().manual_seed(5)))
        runs = {}
        for dev in (TRAIN_DEVICE, "cpu"):
            trainer = train_mod.MlpTrainer(cfg, FEAT_D, dev)
            model = trainer.train_model(init)
            opt = train_mod.make_optimizer(cfg, model.parameters())
            x_dev, y_dev = trainer.to_device(x_tr), trainer.to_device(y_tr)
            losses = []
            for lr, perm in zip(train_mod.reference_lr_sequence(cfg), perms):
                train_mod.set_lr(opt, lr)
                with no_sync() if dev != "cpu" else contextlib.nullcontext():
                    total = trainer.epoch_steps(model, opt, x_dev, y_dev, perm, torch.Generator(dev))
                losses.append(total.item() / len(perm))
            runs[dev] = ({k: v.cpu() for k, v in train_mod.state_of(model).items()}, losses)
        (gpu, gl), (cpu, cl) = runs[TRAIN_DEVICE], runs["cpu"]
        r = out[name] = {"losses": {"cuda": gl, "cpu": cl}, "max_abs_diff": {}}
        bad = []
        for k in cpu:
            diff = (gpu[k] - cpu[k]).abs()
            r["max_abs_diff"][k] = diff.max().item()
            if not (diff <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * cpu[k].abs()).all():
                bad.append(k)
        if not np.allclose(gl, cl, **TRAIN_TOL):
            bad.append("losses")
        print(f"  (b) {name}, {len(x_tr)} rows x {FEAT_D}, 2 epochs: losses cuda {gl} cpu {cl}; largest "
              f"|difference| { {k: f'{v:.2e}' for k, v in r['max_abs_diff'].items()} } (rtol 2e-3, atol 2e-4)")
        if bad:
            raise AssertionError(f"CUDA and CPU training ({name}) disagree on {bad}")
    return out


def run_training(vec540: np.ndarray) -> dict:
    lap = Laps()
    os.makedirs(TRAIN_DIR, exist_ok=True)
    p = lambda name: os.path.join(TRAIN_DIR, name)  # noqa: E731
    reset_counts()
    out = {"host_ram_bytes": host_ram_bytes(), "seconds": lap.seconds}

    print(f"  data: KoNViD-1k shape {KONVID_N} x {FEAT_D}, LSVQ shape {LSVQ_TRAIN_N} + {LSVQ_TEST_N}")
    t0 = time.perf_counter()
    x_a, mos_a = synthetic_features(KONVID_N, seed=1)
    np.save(p("konvid.npy"), x_a)
    write_meta(p("konvid.csv"), "k", mos_a)
    meta_a = {"vid": np.array([f"k{i}" for i in range(KONVID_N)], dtype=object), "mos": mos_a}
    scaled_a, _, scaler_a = protocol_mod.preprocess_like_reference(x_a, mos_a)
    np.save(p("konvid_scaled.npy"), scaled_a)

    # LSVQ: host float64 preprocessing takes about 5 copies of the train matrix
    n_tr = LSVQ_TRAIN_N
    need = 5.2 * 8 * (n_tr + LSVQ_TEST_N) * FEAT_D
    if need > out["host_ram_bytes"] / 2:
        n_tr = int(n_tr * out["host_ram_bytes"] / 2 / need)
        print(f"  LSVQ train rows cut to {n_tr}: preprocessing needs ~{need:.3g} B, RAM {out['host_ram_bytes']}")
    out["lsvq_train_rows"] = n_tr
    x_c, mos_c = synthetic_features(n_tr, seed=2)
    half = n_tr // 2
    import scipy.io

    chunks = []
    for k, sl in enumerate((slice(0, half), slice(half, n_tr))):
        chunks.append(p(f"lsvq_train_{k}.mat"))
        scipy.io.savemat(chunks[-1], {"lsvq_train": x_c[sl]})
    write_meta(p("lsvq_train.csv"), "t", (mos_c - 1) * 99 / 4 + 1)
    del x_c
    x_t, mos_t = synthetic_features(LSVQ_TEST_N, seed=3)
    np.save(p("lsvq_test.npy"), x_t)
    write_meta(p("lsvq_test.csv"), "s", (mos_t - 1) * 99 / 4 + 1)
    del x_t
    out["data_s"] = time.perf_counter() - t0
    print(f"  data made and written in {out['data_s']:.1f} s")
    lap("data")

    print("  (a) train, KoNViD-1k shape, default TrainConfig, 2 repeats")
    medians = []
    saved_select = protocol_mod.select_median_model

    def keep_median(*args):
        medians.append(saved_select(*args))
        return medians[-1]

    protocol_mod.select_median_model = keep_median
    try:
        out["a"] = run_cli(["train", "--metadata-csv", p("konvid.csv"), "--features", p("konvid.npy"),
                            "--output", p("konvid_head.npz"), "--n-repeats", "2",
                            "--device", TRAIN_DEVICE], "(a) train")
    finally:
        protocol_mod.select_median_model = saved_select
    srcc = out["a"]["result"]["median_srcc"]
    if not srcc >= SRCC_MIN:
        raise AssertionError(f"(a) median test SRCC {srcc} below {SRCC_MIN}")
    # the saved head through the predictor's loader against trainer.predict
    median = medians[0][0]
    mlp_state = mlp_from_jax(load_snapshot_variables(p("konvid_head.npz")))
    head = Mlp(FEAT_D, use_bn="bn1.weight" in mlp_state)
    head.load_state_dict(mlp_state)
    head = head.to(TRAIN_DEVICE).eval()
    trainer = train_mod.MlpTrainer(train_mod.TrainConfig(), FEAT_D, TRAIN_DEVICE)
    want = trainer.predict(median.snapshot, scaled_a)
    with torch.inference_mode():
        got = head(torch.from_numpy(scaled_a).to(TRAIN_DEVICE)).reshape(-1).cpu().numpy()
    reload_err = float(np.abs(got - want).max())
    mos = VideoQualityPredictor(types.SimpleNamespace(device=torch.device(TRAIN_DEVICE)), mlp_state,
                                scaler_a).predict_feature(vec540)
    out["a"].update(reload_max_abs_diff=reload_err, mos_540p=mos)
    print(f"  (a) reloaded head against trainer.predict: largest |difference| {reload_err:.3e} (atol 1e-5); "
          f"phase 5's 540p vector -> MOS {mos!r}")
    if not reload_err <= 1e-5 or not math.isfinite(mos):
        raise AssertionError(f"(a) reloaded head: difference {reload_err}, MOS {mos}")
    lap("a")

    print("  (b) CUDA against CPU, first fold of (a), 2 epochs, dropout 0, SWA off, (a)'s and (c)'s heads")
    out["b"] = cuda_vs_cpu_training(meta_a, x_a)
    del x_a
    lap("b")

    print(f"  (c) train-lsvq, {n_tr} train x {LSVQ_TEST_N} test, k-fold off, no BN, lr 1e-2, bykrcc, 20 epochs")
    out["c"] = run_cli(["train-lsvq", "--train-metadata", p("lsvq_train.csv"), "--test-metadata",
                        p("lsvq_test.csv"), "--train-features", *chunks, "--test-features",
                        p("lsvq_test.npy"), "--output", p("lsvq_head.npz"), "--device", TRAIN_DEVICE],
                       "(c) train-lsvq")
    out["c"]["host_peak_rss_bytes"] = peak_rss_bytes()
    print(f"  (c) host peak RSS {out['c']['host_peak_rss_bytes']} B of {out['host_ram_bytes']}")
    if not all(math.isfinite(v) for k, v in out["c"]["result"].items() if k != "model"):
        raise AssertionError(f"(c) metrics not finite: {out['c']['result']}")
    lap("c")

    argv = ["finetune", "--dataset", "konvid_1k", "--metadata-csv", p("konvid.csv"), "--features",
            p("konvid_scaled.npy"), "--base-model", p("lsvq_head.npz"), "--no-bn", "--n-repeats", "2",
            "--output", p("ft_head.npz"), "--device", TRAIN_DEVICE]
    print("  (d) finetune and finetune --zero-shot: (c)'s head on (a)'s scaled features, 2 repeats")
    out["d"] = run_cli(argv, "(d) finetune", profile_epoch=-1)
    out["d_zero_shot"] = run_cli(argv + ["--zero-shot"], "(d) zero-shot", profile_epoch=-1)
    for key in ("d", "d_zero_shot"):
        if not all(math.isfinite(v) for v in out[key]["result"].values() if isinstance(v, float)):
            raise AssertionError(f"({key}) metrics not finite: {out[key]['result']}")

    lap("d")
    print("  step time at full width (BN, SGD, dropout 0.1)")
    out["step"] = head_step_time(train_mod.MlpTrainer(train_mod.TrainConfig(), FEAT_D, TRAIN_DEVICE))
    lap("step time")
    n = counts()
    print(f"  launches of K1, K2, K3 during training: {n} (expected none)")
    if any(n.values()):
        raise AssertionError(f"the training path launched {n}")
    for name in os.listdir(TRAIN_DIR):
        if name.endswith((".mat", ".npy")):
            os.remove(p(name))
    lap.show("phase 7")
    return out


# ------------------------------------------------------------------ phase 8
EXTRACT_DIR = os.path.join(WORK_DIR, "extract")
N_EXTRACT = 4   # LIVE-Qualcomm-shaped clips: 1080x1920, 40 raw frames at 4 fps -> 20 frames, 20 pairs
RESIDUAL = ("frame_diff", "optical_flow", "frame_diff_frag", "optical_flow_frag")
TAPS = (("resnet50", "pool"), ("resnet50", "last_layer"), ("resnet50", "layer_stack"), ("vit", "pool"))
WIDTH = {"pool": 2051, "last_layer": 2048, "layer_stack": 13120}


def extraction_combinations() -> list:
    """Every (mode, network, layer) but ``full`` that stores a distinct
    result: 24."""
    combos = [(m, n, lay) for m in (*RESIDUAL, "layer") for n, lay in TAPS]
    return combos + [("layer_stack", "resnet50", "pool"), ("layer_stack", "vit", "pool"),
                     ("fragment_layerstack", "resnet50", "pool"), ("fragment_pool", "resnet50", "pool")]


def expected_extraction(mode: str, network: str, layer: str, frames: int, pairs: int, chunk: int,
                        flow_calls: int, vit_calls: int):
    """(rows, width) of the stored matrix and the launches of K1-K3 for one
    video: the flow (``flow_calls`` of K1 and of K2: pyramid levels x
    iterations) once per chunk of pairs, ``vit_calls`` of K3 (the ViT's
    depth) per ViT forward (one over the frames, one per chunk of pairs)."""
    n_chunks = -(-pairs // chunk)
    flow = flow_calls * n_chunks if mode.startswith(("optical_flow", "fragment_")) else 0
    if mode in ("layer", "layer_stack"):
        rows, vit_forwards = frames, int(network == "vit")
    else:
        rows = pairs
        vit_forwards = n_chunks if mode == "fragment_pool" or (mode in RESIDUAL and network == "vit") else 0
    if mode.startswith("fragment_"):
        width = 15171 if mode == "fragment_layerstack" else 4608
    elif network == "vit":
        width = 2304
    else:
        width = 13120 if mode == "layer_stack" else WIDTH[layer]
    return (rows, width), {"K1": flow, "K2": flow, "K3": vit_calls * vit_forwards}


def run_extract_cli(argv: list) -> dict:
    """``cli.main(["extract", ...])`` in-process -> its JSON line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["extract", *argv])
    return json.loads(out.getvalue().strip().splitlines()[-1])


@contextlib.contextmanager
def extraction_instruments():
    """While inside: ``cli._build_extractor`` builds once (the seeded random
    weights of a run without checkpoints) and every later ``extract`` gets
    that extractor; every ``video_feature_async_i420`` runs under
    ``no_sync``."""
    built = []
    build, enqueue = cli._build_extractor, FeatureExtractor.video_feature_async_i420

    def build_once(args):
        if not built:
            built.append(build(args))
        return built[0]

    def guarded(self, *args, **kwargs):
        with no_sync():
            return enqueue(self, *args, **kwargs)

    cli._build_extractor, FeatureExtractor.video_feature_async_i420 = build_once, guarded
    try:
        yield built
    finally:
        cli._build_extractor, FeatureExtractor.video_feature_async_i420 = build, enqueue


@contextlib.contextmanager
def extract_host_split():
    """While inside: host seconds of the decode (``decode_video``, in a
    decode thread) and of ``_extract_one`` (upload, conversion and the
    enqueue of every launch) inside ``extract``; the rest of a run's wall
    time is the wait for the device at the fetch plus the CLI's own work."""
    timers = Timers()
    saved = cli.decode_video, cli._extract_one
    cli.decode_video = timers.wrap("decode", saved[0])
    cli._extract_one = timers.wrap("enqueue", saved[1])
    try:
        yield timers
    finally:
        cli.decode_video, cli._extract_one = saved


def write_extract_meta(name: str, vids: list) -> str:
    path = os.path.join(EXTRACT_DIR, name)
    with open(path, "w") as f:
        f.write("vid,mos,framerate,width,height\n")
        f.writelines(f"{v},{50 + i},4,{W_HI},{H_HI}\n" for i, v in enumerate(vids))
    return path


def extract_cuda_vs_cpu() -> dict:
    """Each mode's stored matrix from ``_extract_one`` on the card and on the
    CPU (2 frames and 2 pairs at 240x320, depth-2 ViT, f32 with TF32 off):
    cosine of the whole matrix >= 0.99999 (per segment for ``full``)."""
    rs, vs = seeded_states(vit_depth=2)
    frames = synthetic_bgr(4, 240, 320, seed=5)
    fbuf, nbuf = bgr_to_i420(frames[0::2]), bgr_to_i420(frames[1::2])
    cases = [("full", "resnet50", "pool"), ("layer_stack", "resnet50", "pool"), ("layer", "resnet50", "last_layer"),
             ("fragment_layerstack", "resnet50", "pool"), ("fragment_pool", "resnet50", "pool"),
             ("frame_diff", "resnet50", "pool"), ("frame_diff_frag", "resnet50", "layer_stack"),
             ("optical_flow", "vit", "pool"), ("optical_flow_frag", "vit", "pool")]
    outs = {}
    for dev in ("cpu", "cuda"):
        fx = FeatureExtractor(rs, vs, dtype=torch.float32, vit_depth=2, device=dev)
        abl = AblationExtractor(fx)
        outs[dev] = [cli._extract_one(fx, abl, *case, "i420", (fbuf, nbuf, 240, 320)).cpu().numpy()
                     .astype(np.float64) for case in cases]
    r = {}
    for case, got, want in zip(cases, outs["cuda"], outs["cpu"]):
        if case[0] == "full":
            cos = min(segment_cosines(got, want).values())
        else:
            cos = float(got.ravel() @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want)))
        diff = float(np.abs(got - want).max())
        r["/".join(case)] = {"cosine": cos, "max_abs_diff": diff, "shape": list(got.shape)}
        print(f"  {'/'.join(case)} {got.shape}: cosine(cuda, cpu) {cos:.8f} (bound 0.99999), "
              f"largest |difference| {diff:.3e}")
        if not (cos >= 0.99999 and np.isfinite(got).all()):
            raise AssertionError(f"extraction {case}: CUDA against CPU cosine {cos}")
    return r


def vgg_check() -> dict:
    """VGG-16 with seeded weights, a batch of 16 at 224x224: CUDA f32
    against CPU f32 (every raw tap and fc2: max error over the tap's max <=
    1e-4), bf16 against f32 (per-tap cosine >= 0.999); ms per batch by
    events in both types, with ``reduce="mean"``, and peak memory."""
    model = random_init_(VGG16(), 0).eval()
    x = torch.randn((16, 3, 224, 224), generator=torch.Generator().manual_seed(8))
    r = {"f32_vs_cpu": {}, "bf16_vs_f32_cosine": {}}
    with torch.inference_mode():
        want = model(x, reduce=None)
        gpu = copy.deepcopy(model).cuda()
        xc = x.cuda()
        got = gpu(xc, reduce=None)
        for name, t in got.items():
            _, rel = rel_err(t, want[name].cuda())
            r["f32_vs_cpu"][name] = rel
        worst = max(r["f32_vs_cpu"].values())
        print(f"  VGG-16 CUDA f32 against CPU f32, 13 taps and fc2: largest error / max |tap| {worst:.3e} "
              f"(bound 1e-4)")
        if not worst <= 1e-4:
            raise AssertionError(f"VGG-16 CUDA against CPU: {r['f32_vs_cpu']}")
        del want
        half = copy.deepcopy(gpu).to(torch.bfloat16)
        low = half(xc.to(torch.bfloat16), reduce=None)
        for name, t in low.items():
            a, b = t.double().ravel(), got[name].double().ravel()
            r["bf16_vs_f32_cosine"][name] = float(a @ b / (a.norm() * b.norm()))
        low_cos = min(r["bf16_vs_f32_cosine"].values())
        print(f"  VGG-16 bf16 against f32: lowest per-tap cosine {low_cos:.6f} (bound 0.999)")
        if not low_cos >= 0.999:
            raise AssertionError(f"VGG-16 bf16 drifts from f32: {r['bf16_vs_f32_cosine']}")
        del got, low
        for tag, net, inp in (("f32", gpu, xc), ("bf16", half, xc.to(torch.bfloat16))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r[f"{tag}_ms"] = cuda_ms(lambda: net(inp), iters=10)
            r[f"{tag}_max_memory_allocated"] = torch.cuda.max_memory_allocated()
            print(f"  VGG-16 {tag}, batch 16: {r[f'{tag}_ms']:.3f} ms a batch (events), "
                  f"max_memory_allocated {r[f'{tag}_max_memory_allocated']}")
    return r


def run_extraction() -> tuple[dict, np.ndarray]:
    """Phase 8 -> its record and (a)'s one-process `full` matrix."""
    lap = Laps()
    out = {"seconds": lap.seconds}

    shutil.rmtree(EXTRACT_DIR, ignore_errors=True)  # no store left by an earlier run
    os.makedirs(os.path.join(EXTRACT_DIR, "LIVE-Qualcomm"))
    vids = [f"clip{i}" for i in range(N_EXTRACT)]
    clips = [make_clip(os.path.join("extract", "LIVE-Qualcomm", f"{v}.yuv"), FRAMES_HI, H_HI, W_HI, seed=40 + i)
             for i, v in enumerate(vids)]
    meta = write_extract_meta("meta.csv", vids)
    meta_one = write_extract_meta("meta_one.csv", vids[:1])
    base = ["--dataset", "live_qualcomm", "--root", EXTRACT_DIR, "--decode-workers", "4"]
    runs = itertools.count()

    def fresh() -> str:
        return os.path.join(EXTRACT_DIR, f"out{next(runs)}")

    lap("clips")
    with extraction_instruments() as built:
        print(f"  (a) extract --mode full: {N_EXTRACT} clips {H_HI}x{W_HI}, {FRAMES_HI // 2} frames and pairs each")
        out_a, mat_path = fresh(), os.path.join(EXTRACT_DIR, "full.mat")
        reset_counts()
        line = run_extract_cli([*base, "--metadata-csv", meta, "--output", out_a, "--dispatch-ahead", "2",
                                "--save-mat", mat_path])
        fx = built[0]
        chunk = fx.max_pair_batch(H_HI, W_HI)
        calls = (len(pyramid_levels(H_HI, W_HI)) * FARNEBACK_PARAMS["iterations"], len(fx.vit.blocks))
        n_chunks = -(-(FRAMES_HI // 2) // chunk)
        per_video = {"K1": calls[0] * n_chunks, "K2": calls[0] * n_chunks, "K3": calls[1] * (1 + n_chunks)}
        r = out["a"] = {"line": line, "launches": check_counts(
            "(a) full", {k: v * N_EXTRACT for k, v in per_video.items()})}
        if line != {"dataset": "live_qualcomm", "mode": "full", "shape": [N_EXTRACT, TOTAL_FEATURE_DIM]}:
            raise AssertionError(f"(a) result line {line}")
        store = FeatureStore(out_a)
        rows = np.stack([store.get("live_qualcomm", i) for i in range(N_EXTRACT)])
        r["vs_single"] = [check_cosines(f"(a) stored row {i} vs video_feature_i420", row,
                                        fx.video_feature_i420(*decode_video_inputs_i420(c, 4.0, W_HI, H_HI)),
                                        COS_BOUND["bf16"]) for i, (row, c) in enumerate(zip(rows, clips))]
        mat = full_mat = np.load(os.path.join(out_a, "live_qualcomm_features.npy"))
        if not np.array_equal(mat, rows):
            raise AssertionError("(a) the .npy matrix differs from the stored rows")
        if not np.array_equal(load_mat_features(mat_path, "live_qualcomm"), mat.astype(float)):
            raise AssertionError("(a) the --save-mat file does not reload unchanged")
        print("  (a) the .npy matrix equals the stored rows; the .mat reloads unchanged")
        reset_counts()
        again = run_extract_cli([*base, "--metadata-csv", meta, "--output", out_a])
        r["resume_launches"] = check_counts("(a) resume", {"K1": 0, "K2": 0, "K3": 0})
        if again != line or not np.array_equal(np.load(os.path.join(out_a, "live_qualcomm_features.npy")), mat):
            raise AssertionError("(a) the resumed run changed the result")
        t = r["timing"] = timed(lambda: run_extract_cli([*base, "--metadata-csv", meta, "--output", fresh(),
                                                         "--dispatch-ahead", "2"]))
        r["warm_ms_per_video"] = t["ms_median"] / N_EXTRACT
        print(f"  (a) fresh run: {r['warm_ms_per_video']:.2f} ms per video (runs {t['ms']} for {N_EXTRACT}), "
              f"busy share {t['busy_share']}, max_memory_allocated {t['max_memory_allocated']}")
        lap("a")

        print(f"  (b) every other mode on clip0 ({FRAMES_HI // 2} frames, {FRAMES_HI // 2} pairs, chunks of {chunk})")
        out["b"] = {}
        for mode, network, layer in extraction_combinations():
            argv = [*base, "--metadata-csv", meta_one, "--mode", mode, "--network", network, "--layer", layer]
            shape, want = expected_extraction(mode, network, layer, FRAMES_HI // 2, FRAMES_HI // 2, chunk, *calls)
            ms = []
            for _ in range(2):  # cold, then warm
                reset_counts()
                out_b = fresh()
                with extract_host_split() as timers:
                    t0 = time.perf_counter()
                    line = run_extract_cli([*argv, "--output", out_b])
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                got = counts()
            split = {k: v * 1e3 for k, v in timers.s.items()}
            stored = FeatureStore(out_b).get(f"live_qualcomm_{mode}", 0)
            key = f"{mode}/{network}/{layer}"
            out["b"][key] = {"shape": list(stored.shape), "launches": got, "ms_cold": ms[0], "ms": ms[1],
                             "host_ms": split}
            print(f"  {key}: {stored.shape}, launches {got}, {ms[1]:.1f} ms per video warm ({ms[0]:.1f} cold); "
                  f"host ms decode {split['decode']:.1f}, enqueue {split['enqueue']:.1f}, "
                  f"rest {ms[1] - sum(split.values()):.1f}")
            if stored.shape != shape or line["shape"] != [1, shape[1]] or not np.isfinite(stored).all():
                raise AssertionError(f"(b) {key}: stored {stored.shape}, line {line}, expected {shape}")
            if got != want:
                raise AssertionError(f"(b) {key}: launches {got}, expected {want}")

        lap("b")
        print("  (e) extract --profile-dir")
        trace_dir = os.path.join(EXTRACT_DIR, "trace")
        run_extract_cli([*base, "--metadata-csv", meta_one, "--output", fresh(), "--mode", "layer",
                         "--network", "vit", "--profile-dir", trace_dir])
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        out["e"] = {"files": len(traces), "bytes": os.path.getsize(traces[0]), "kernel_events": kernels}
        print(f"  (e) trace: {out['e']}")
        if len(traces) != 1 or not events or (fx.device.type == "cuda" and not kernels):
            raise AssertionError(f"(e) --profile-dir wrote {out['e']}")
        del fx, built[:]
    torch.cuda.empty_cache()
    lap("e")

    print("  (c) CUDA against CPU, every mode (240x320, 2 frames and 2 pairs, depth-2 ViT, f32)")
    out["c"] = extract_cuda_vs_cpu()
    lap("c")
    print("  (d) VGG-16, seeded, batch 16 at 224x224")
    out["d"] = vgg_check()
    shutil.rmtree(EXTRACT_DIR)
    lap("d")
    lap.show("phase 8")
    return out, full_mat


# ------------------------------------------------------------------ phase 9
INGEST_DIR = os.path.join(WORK_DIR, "ingest")
H_LO, W_LO = 360, 640
FRAG_ENTRIES = 15171 + 4608  # frag_resnet and frag_vit: NaN for a video with no pairs


class UploadBytes:
    """While inside: bytes that ``fx._upload`` sends to the device."""

    def __init__(self, fx: FeatureExtractor):
        self.fx, self.n = fx, 0

    def __enter__(self):
        inner = self.fx._upload

        def counted(arrays):
            self.n += sum(np.asarray(a).nbytes for a in arrays)
            return inner(arrays)
        self.fx._upload = counted
        return self

    def __exit__(self, *exc):
        del self.fx._upload


def i420_clip(n_frames: int, h: int, w: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Packed I420 sampled frames and successors of a seeded clip."""
    x = synthetic_bgr(2 * n_frames, h, w, seed)
    return bgr_to_i420(x[0::2]), bgr_to_i420(x[1::2])


def run_ingest() -> dict:
    """Phase 9: what follows the decode of a container, at full width, on
    seeded frames; and in (e) a real mp4 decoded through cv2, which the
    card's host has (libav it has not)."""
    os.makedirs(INGEST_DIR, exist_ok=True)
    lap = Laps()
    out = {"seconds": lap.seconds}

    rs, vs = seeded_states(vit_depth=12)
    fx = FeatureExtractor(rs, vs, dtype=torch.bfloat16, vit_depth=12, device="cuda")
    scaler = FeatureScaler(fill=np.zeros(1), scale=np.ones(1), offset=np.zeros(1))
    pred = VideoQualityPredictor(fx, random_init_(Mlp(), 2).state_dict(), scaler)
    per_flow = len(pyramid_levels(H, W)) * FARNEBACK_PARAMS["iterations"]
    depth = len(fx.vit.blocks)

    print(f"  (a) the BGR program against the I420 program: {H}x{W}, {FRAMES} frames and {PAIRS} pairs")
    clip = make_clip(os.path.join("ingest", "clip540p.yuv"), 2 * FRAMES, H, W, seed=50)
    fbuf, nbuf, h, w = decode_video_inputs_i420(clip, 4.0, W, H)
    frames, nxt = (np.stack([_yuv420_to_bgr_limited(row.reshape(h * 3 // 2, w), w, h) for row in b])
                   for b in (fbuf, nbuf))  # the host converter's BGR frames
    prev = frames[: len(nxt)]  # the prefix view decode_video_inputs gives
    if (len(frames), len(nxt)) != (FRAMES, PAIRS):
        raise AssertionError(f"(a) decode gave {len(frames)} frames, {len(nxt)} pairs")
    vec_i420 = fx.video_feature_i420(fbuf, nbuf, h, w)
    reset_counts()
    with no_sync(), UploadBytes(fx) as up_bgr:
        pending = fx.video_feature_async(frames, prev, nxt)
    vec_bgr = pending.cpu().numpy()
    r = out["a"] = {"launches": check_counts("(a) BGR program", {"K1": per_flow, "K2": per_flow, "K3": depth})}
    with UploadBytes(fx) as up_i420:
        fx.video_feature_async_i420(fbuf, nbuf, h, w).cpu()
    r["upload_bytes"] = {"bgr": up_bgr.n, "i420": up_i420.n}
    r["max_abs_diff"] = float(np.abs(vec_bgr - vec_i420).max())
    print(f"  (a) bytes uploaded a video: BGR {up_bgr.n}, I420 {up_i420.n}; BGR against I420 vector: "
          f"largest |difference| {r['max_abs_diff']:.3e} (expected 0: the same uint8 frames)")
    if not np.isfinite(vec_bgr).all() or not np.array_equal(vec_bgr, vec_i420):
        raise AssertionError(f"(a) the BGR vector is not the I420 vector: {r['max_abs_diff']}")
    if (up_bgr.n, up_i420.n) != (2 * PAIRS * H * W * 3, 2 * PAIRS * H * W * 3 // 2):
        raise AssertionError(f"(a) uploads {up_bgr.n} and {up_i420.n} B: frames not uploaded once")
    r["timing"] = {
        "bgr": timed(lambda: fx.video_feature_async(frames, prev, nxt).cpu()),
        "i420": timed(lambda: fx.video_feature_async_i420(fbuf, nbuf, h, w).cpu()),
    }
    for k, t in r["timing"].items():
        print(f"  (a) {k} ingest, enqueue and fetch: {t['ms_median']:.2f} ms a video (runs {t['ms']}), "
              f"busy share {t['busy_share']}, max_memory_allocated {t['max_memory_allocated']}")
    lap("a")

    print("  (b) predict_arrays against predict_feature of (a)'s vector")
    mos_vec, mos_arr = pred.predict_feature(vec_i420), pred.predict_arrays(frames, prev, nxt)
    out["b"] = {"predict_feature": mos_vec, "predict_arrays": mos_arr}
    print(f"  (b) MOS {mos_arr!r} against {mos_vec!r}")
    if not math.isfinite(mos_arr) or abs(mos_arr - mos_vec) > 1e-5:
        raise AssertionError(f"(b) predict_arrays {mos_arr} against predict_feature {mos_vec}")
    lap("b")

    print(f"  (c) predict_batch --batch 2 grouping: 540p, 360p, 540p, 360p, 540p ({FRAMES} frames, {PAIRS} pairs)")
    shapes = [(H, W), (H_LO, W_LO), (H, W), (H_LO, W_LO), (H, W)]
    paths = [f"clip{i}_{hh}x{ww}.mp4" for i, (hh, ww) in enumerate(shapes)]
    decoded = {p: ("i420", (*i420_clip(FRAMES, hh, ww, seed=60 + i), hh, ww))
               for i, (p, (hh, ww)) in enumerate(zip(paths, shapes))}
    single = [fx.video_feature_i420(*decoded[p][1]) for p in paths]
    vectors = types.SimpleNamespace(extractor=fx, predict_feature=lambda v: v.numpy())
    chunks = {key: -(-2 * PAIRS // fx.max_pair_batch(*key)) for key in ((H, W), (H_LO, W_LO))}
    flows = {key: len(pyramid_levels(*key)) * FARNEBACK_PARAMS["iterations"] for key in chunks}
    k12 = sum(flows[key] * chunks[key] for key in chunks) + flows[(H, W)]
    reset_counts()
    rows = predict_batch(vectors, paths, decoded.__getitem__, batch=2)
    r = out["c"] = {"launches": check_counts("(c) predict_batch", {"K1": k12, "K2": k12, "K3": 3 * depth})}
    if [p for p, _ in rows] != paths:
        raise AssertionError(f"(c) rows out of order: {[p for p, _ in rows]}")
    r["vs_single"] = [check_cosines(f"(c) row {i} ({p}) vs single", v, s, COS_BOUND["bf16"])
                      for i, ((p, v), s) in enumerate(zip(rows, single))]
    mos = [m for _, m in predict_batch(pred, paths, decoded.__getitem__, batch=2)]
    r["mos"] = mos
    print(f"  (c) MOS {mos}")
    if not all(math.isfinite(m) for m in mos):
        raise AssertionError(f"(c) MOS not finite: {mos}")
    del decoded, single
    lap("c")

    print(f"  (d) a {H}x{W} clip with one sampled frame and no pairs")
    fbuf1, _ = i420_clip(1, H, W, seed=70)
    reset_counts()
    with no_sync():
        pending = fx.video_feature_async_i420(fbuf1, fbuf1[:0], H, W)
    vec = pending.cpu().numpy()
    r = out["d"] = {"launches": check_counts("(d) no pairs", {"K1": 0, "K2": 0, "K3": depth})}
    nan = np.isnan(vec)
    r.update(nan_entries=int(nan.sum()), mos=pred.predict_feature(vec))
    print(f"  (d) NaN entries {r['nan_entries']} (expected the {FRAG_ENTRIES} fragment entries), MOS {r['mos']!r}")
    if not (nan[-FRAG_ENTRIES:].all() and np.isfinite(vec[:-FRAG_ENTRIES]).all() and math.isfinite(r["mos"])):
        raise AssertionError(f"(d) NaN entries {r['nan_entries']}, MOS {r['mos']}")
    lap("d")

    print("  (e) the container decoder on this host")
    out["e"] = r = {"native_loads": native.available(), "loader_error": native.load_error()}
    try:
        import cv2
        r["cv2"] = cv2.__version__
    except ImportError:
        cv2 = None
    print(f"  (e) native decoder loads: {r['native_loads']} ({r['loader_error']}); cv2: {r.get('cv2')}")
    mp4 = os.path.join(INGEST_DIR, "clip540p.mp4")
    with open(mp4, "wb") as f:
        f.write(b"\0" * 4096)
    saved = native.available, sys.modules.get("cv2")
    native.available, sys.modules["cv2"] = (lambda: False), None  # a host with neither decoder
    try:
        pred.predict_file(mp4, ingest="auto")
    except DecoderUnavailable as e:
        r["refusal"] = str(e)
        print(f"  (e) with both decoders off, predict_file on an mp4 raised DecoderUnavailable: {e}")
    else:
        raise AssertionError("(e) predict_file decoded an mp4 with both decoders off")
    finally:
        native.available = saved[0]
        if saved[1] is None:
            sys.modules.pop("cv2")
        else:
            sys.modules["cv2"] = saved[1]
    writer = cv2 and cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 4, (W, H))
    if cv2 is not None and not writer.isOpened():
        print("  (e) cv2 cannot write mp4v on this host: no container to decode")
    elif cv2 is not None:  # a real container, BGR-decoded (through cv2 where libav does not load)
        for fr in synthetic_bgr(2 * FRAMES, H, W, seed=50).cpu().numpy():
            writer.write(fr)
        writer.release()
        t0 = time.perf_counter()
        kind, data = decode_video(mp4, ingest="bgr")
        r["decode_ms"] = (time.perf_counter() - t0) * 1e3
        if kind != "bgr" or (len(data[0]), len(data[2])) != (FRAMES, PAIRS):
            raise AssertionError(f"(e) the mp4 decoded as {kind}, {len(data[0])} frames, {len(data[2])} pairs")
        want = fx.video_feature(*data)
        reset_counts()
        vec = pred.enqueue_file(mp4, ingest="bgr").cpu().numpy()
        r["launches"] = check_counts("(e) predict_file on the mp4", {"K1": per_flow, "K2": per_flow, "K3": depth})
        r["mos"] = pred.predict_feature(vec)
        print(f"  (e) the mp4 through {'libav' if r['native_loads'] else 'cv2'} and the BGR program: decode {r['decode_ms']:.1f} ms, "
              f"MOS {r['mos']!r}, vector equal to the BGR program's on the decoded frames: "
              f"{np.array_equal(vec, want)}")
        if not (np.array_equal(vec, want) and math.isfinite(r["mos"])):
            raise AssertionError(f"(e) the mp4's vector or MOS ({r['mos']}) is wrong")
    lap("e")

    print(f"  (f) warmup {H}x{W} x {FRAMES}, and the link probe")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["warmup", "--resolutions", f"{H}x{W}", "--counts", str(FRAMES)])
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    print(f"  (f) warmup records: {recs}")
    if [(x["resolution"], x["frames"], x["pairs"]) for x in recs] != [(f"{H}x{W}", FRAMES, PAIRS)]:
        raise AssertionError(f"(f) warmup printed {recs}")
    link = measure_link()
    mode = pick_serving_mode(fbuf.nbytes + nbuf.nbytes, link)
    out["f"] = {"warmup": recs, "link": link, "serving_mode": mode}
    print(f"  (f) measure_link: {link}; pick_serving_mode for {fbuf.nbytes + nbuf.nbytes} B a video: {mode}")
    lap("f")

    print("  (g) a CUDA index other than 0")
    try:
        resolve_device("cuda:1")
    except ValueError as e:
        out["g"] = str(e)
        print(f"  (g) resolve_device('cuda:1') raised: {e}")
    else:
        raise AssertionError("(g) resolve_device('cuda:1') was accepted")
    del fx, pred
    torch.cuda.empty_cache()
    shutil.rmtree(INGEST_DIR)
    lap("g")
    lap.show("phase 9")
    return out


# ------------------------------------------------------------------ phase 10
MESH_DIR = os.path.join(WORK_DIR, "mesh")
HEAD_BATCH, HEAD_STEPS_DP, TP_STEPS = 256, 20, 3
RANK_TIMEOUT_S = 300
DP_RTOL = 1e-5


def _rank_entry(rank: int, fn, world: int, out_dir: str, args) -> None:
    """One rank of a group on the one card: join through gloo (NCCL places
    one rank on one device), run ``fn``, write its JSON result."""
    initialize(f"file://{os.path.join(out_dir, 'store')}", world, rank, backend="gloo", device="cuda:0",
               timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    result = fn(rank, *args)
    torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


def run_ranks(fn, world: int, *args) -> list:
    """``fn(rank, *args)`` in ``world`` processes started as
    torch.multiprocessing starts them (spawn), all on cuda:0 through gloo,
    joined with a timeout; a rank that fails fails the phase.  The kernel
    library is built already: the ranks load it."""
    out_dir = os.path.join(MESH_DIR, fn.__name__)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = torch.multiprocessing.start_processes(_rank_entry, args=(fn, world, out_dir, args), nprocs=world,
                                                join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"{fn.__name__}: {world} ranks still running after {RANK_TIMEOUT_S} s")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


class GuardedLaunches:
    """While inside: every C call of the kernel library is counted, and
    counted as guarded when it runs inside ``torch.cuda.device`` (the guard
    ``_native.launch`` puts around it)."""

    def __enter__(self):
        self.launches = self.guarded = self.depth = 0
        outer, self.saved = self, (torch.cuda.device, dict(_native._fns))

        class Counted(torch.cuda.device):
            def __enter__(self):
                outer.depth += 1
                return super().__enter__()

            def __exit__(self, *exc):
                outer.depth -= 1
                return super().__exit__(*exc)

        def counted(fn):
            def call(*args):
                outer.launches += 1
                outer.guarded += outer.depth > 0
                return fn(*args)
            return call

        torch.cuda.device = Counted
        _native._fns.update({name: counted(fn) for name, fn in self.saved[1].items()})
        return self

    def __exit__(self, *exc):
        torch.cuda.device = self.saved[0]
        _native._fns.update(self.saved[1])


def step_timing(step, steps: int = HEAD_STEPS) -> dict:
    """ms of ``step()``: CUDA events over ``steps`` calls, and the
    profiler's device time and kernel launches a call."""
    ms_events = cuda_ms(step, iters=steps, warmup=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return {"ms_events": ms_events,
            "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps,
            "launches_per_step": len(kernels) / steps}


def mesh_one_rank(streamed540: list) -> tuple[dict, dict]:
    """(a): world size 1 under NCCL.  -> the record, and the one-process
    head's init, batch and state after ``TP_STEPS`` steps for (c)."""
    out = {}
    initialize(f"file://{os.path.join(MESH_DIR, 'nccl_store')}", 1, 0, backend="nccl", device="cuda:0",
               timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    mesh = make_mesh(1, 1, "cuda:0")
    print(f"  (a) NCCL {torch.cuda.nccl.version()}, world 1, mesh {mesh.shape}")
    rs, vs = seeded_states(vit_depth=12)
    fx = FeatureExtractor(rs, vs, dtype=torch.bfloat16, vit_depth=12, device="cuda")
    clips = [os.path.join(WORK_DIR, f"serve{i}.yuv") for i in range(len(SERVE_FRAMES))]
    reset_counts()
    with GuardedLaunches() as guard:
        rows = ShardedVideoEvaluator(fx, mesh).run(
            clips, lambda c: ("i420", *decode_video_inputs_i420(c, 4.0, W, H)))
    n = len(clips)
    out["launches"] = check_counts("(a) ShardedVideoEvaluator.run, 4 clips", {k: 12 * n for k in ("K1", "K2", "K3")})
    out["guarded"] = {"launches": guard.launches, "inside_device_guard": guard.guarded,
                      "expansion_launches": poly_expansion.launches, "pyramid_launches": pyramid_level.launches}
    print(f"  (a) kernel library calls {guard.launches} (K1-K3, {poly_expansion.launches} of the expansion and "
          f"{pyramid_level.launches} of the pyramid), "
          f"inside the device guard {guard.guarded}")
    if poly_expansion.launches != 4 * n or pyramid_level.launches != 4 * n:
        raise AssertionError(f"(a) expected {4 * n} expansion and pyramid launches, got {poly_expansion.launches} "
                             f"and {pyramid_level.launches}")
    if (guard.launches != sum(out["launches"].values()) + poly_expansion.launches + pyramid_level.launches
            or guard.guarded != guard.launches):
        raise AssertionError(f"(a) launches outside the device guard: {out['guarded']}")
    same = [bool(np.array_equal(r, v)) for r, v in zip(rows, streamed540, strict=True)]
    out["rows_equal_phase6_streamed"] = same
    print(f"  (a) rows bit-identical to phase 6's streamed vectors: {same}")
    if not all(same):
        raise AssertionError("(a) the sharded rows differ from phase 6's streamed vectors")
    del fx, rs, vs
    torch.cuda.empty_cache()

    print(f"  (a) DistributedMlpTrainStep {FEAT_D} x 256, batch {HEAD_BATCH}, dropout 0, f32, "
          f"{HEAD_STEPS_DP} steps, against the one-process step")
    gen = torch.Generator(device="cuda").manual_seed(12)
    # centred features: from U(0, 1) inputs the head diverges at lr 0.1, and two
    # runs would be compared on chaos
    x = torch.rand((HEAD_BATCH, FEAT_D), generator=gen, device="cuda") - 0.5
    y = 1 + 4 * torch.rand(HEAD_BATCH, generator=gen, device="cuda")
    init = flax_init_(Mlp(FEAT_D, 256, use_bn=False), torch.Generator().manual_seed(11)).state_dict()
    dp = DistributedMlpTrainStep(mesh, FEAT_D, drop_rate=0.0)
    dp.init(state=init)
    trainer = train_mod.MlpTrainer(train_mod.TrainConfig(use_bn=False, drop_rate=0.0), FEAT_D, "cuda")
    model = trainer.train_model(init)
    opt = train_mod.make_optimizer(trainer.cfg, model.parameters())
    losses = {"dp": [], "one": []}
    for i in range(HEAD_STEPS_DP):
        losses["dp"].append(float(dp.step(x, y)))
        losses["one"].append(float(trainer.step(model, opt, x, y, None)))
        if i + 1 == TP_STEPS:
            ref = {"init": init, "x": x.cpu(), "y": y.cpu(), "losses": losses["one"][:],
                   "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}
    state = dp.state()
    out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses["dp"], losses["one"]))
    out["param_rel"] = {k: rel_err(state[k], v)[1] for k, v in model.state_dict().items()}
    out["losses"] = losses
    print(f"  (a) loss after {HEAD_STEPS_DP} steps {losses['dp'][-1]!r} (one process {losses['one'][-1]!r}); "
          f"largest relative difference: loss {out['loss_rel']:.3e}, parameters "
          f"{max(out['param_rel'].values()):.3e} (bound {DP_RTOL:.0e})")
    if not (out["loss_rel"] <= DP_RTOL and max(out["param_rel"].values()) <= DP_RTOL):
        raise AssertionError(f"(a) the distributed step drifts from the one-process step: {out}")
    out["step_timing"] = {
        "distributed": step_timing(lambda: dp.step(x, y)),
        "one_process": step_timing(lambda: trainer.step(model, opt, x, y, None)),
    }
    for k, t in out["step_timing"].items():
        print(f"  (a) {k} step: {t['ms_events']:.4f} ms by events, {t['device_ms']:.4f} ms device time in "
              f"{t['launches_per_step']:.1f} kernels")
    del dp, trainer, model, opt, x, y
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return out, ref


def seeded_predictor(args, extractor) -> VideoQualityPredictor:
    """``cli._load_predictor`` without the pkls (the card's host has no
    joblib): phase 9's seeded head and identity scaler."""
    scaler = FeatureScaler(fill=np.zeros(1), scale=np.ones(1), offset=np.zeros(1))
    return VideoQualityPredictor(extractor, random_init_(Mlp(), 2).state_dict(), scaler)


def run_predict_batch(argv: list) -> dict:
    """``cli.main(["predict-batch", ...])`` with ``seeded_predictor`` -> the
    rows ``predict_batch`` returned on this rank, its launches and stdout."""
    rows, saved = [], (cli._load_predictor, cli.predict_batch)

    def kept(*args, **kwargs):
        out = saved[1](*args, **kwargs)
        rows.extend([path, mos] for path, mos in out)
        return out

    cli._load_predictor, cli.predict_batch = seeded_predictor, kept
    reset_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["predict-batch", *argv])
    finally:
        cli._load_predictor, cli.predict_batch = saved
    return {"rows": rows, "launches": counts(), "stdout": buf.getvalue()}


def _mesh_cli_rank(rank: int, argv: list, outputs: list, predict_argv: list) -> dict:
    """(b)'s rank: ``extract --n-data 2`` into ``outputs[0]`` (cold: the
    launch counts) and ``outputs[1]`` (warm: the wall time), then
    ``predict-batch --n-data 2``, the extractor built once."""
    res = {}
    with extraction_instruments():
        for key, output in zip(("cold", "warm"), outputs):
            reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["extract", *argv, "--output", output])
            torch.cuda.synchronize()
            res[key] = {"s": time.perf_counter() - t0, "launches": counts(), "stdout": buf.getvalue()}
        res["predict"] = run_predict_batch(predict_argv)
    return res


def _dp_tp_rank(rank: int, data_path: str, state_path: str) -> dict:
    """(c)'s rank: ``TP_STEPS`` steps of the 2 x 2 DP x TP head."""
    data = torch.load(data_path, weights_only=False)
    mesh = make_mesh(2, 2, "cuda:0")
    step = DistributedMlpTrainStep(mesh, FEAT_D, drop_rate=0.0)
    step.init(state=data["init"])
    xs, ys, _ = shard_batch(mesh, data["x"], data["y"])
    losses = [float(step.step(xs, ys)) for _ in range(TP_STEPS)]
    state = step.state(keep_pad=True)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in state.items()}, state_path)
    return {"mesh": [mesh.rank, mesh.data_index, mesh.model_index], "cols": list(step.cols), "loss": losses,
            "pad_zero": not state["fc1.weight"][:, FEAT_D:].any().item()}


def run_mesh(streamed540: list, full1080: np.ndarray, one_process: dict) -> dict:
    """Phase 10: the multi-device layer on the one card.  ``streamed540``:
    phase 6's bf16 streamed vectors; ``full1080`` and ``one_process``:
    phase 8 (a)'s matrix and record (launches, warm ms a video)."""
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    lap = Laps()
    out = {"seconds": lap.seconds}

    print("  (a) world size 1 under NCCL: ShardedVideoEvaluator.run on phase 6's four 540p clips")
    out["a"], ref = mesh_one_rank(streamed540)
    lap("a")

    print(f"  (b) extract --mode full --n-data 2: two ranks on cuda:0 through gloo, phase 8's {N_EXTRACT} "
          f"{H_HI}x{W_HI} clips")
    os.makedirs(os.path.join(MESH_DIR, "LIVE-Qualcomm"))
    vids = [f"clip{i}" for i in range(N_EXTRACT)]
    for i, v in enumerate(vids):
        make_clip(os.path.join("mesh", "LIVE-Qualcomm", f"{v}.yuv"), FRAMES_HI, H_HI, W_HI, seed=40 + i)
    meta = os.path.join(MESH_DIR, "meta.csv")
    with open(meta, "w") as f:
        f.write("vid,mos,framerate,width,height\n")
        f.writelines(f"{v},{50 + i},4,{W_HI},{H_HI}\n" for i, v in enumerate(vids))
    argv = ["--dataset", "live_qualcomm", "--root", MESH_DIR, "--metadata-csv", meta, "--decode-workers", "4",
            "--n-data", "2", "--device", "cuda:0"]
    outputs = [os.path.join(MESH_DIR, "out_cold"), os.path.join(MESH_DIR, "out_warm")]
    # predict-batch on phase 6's four 540p clips: the one-process run at
    # --batch 2 runs the batched program on clips 0-1 and 2-3; at --batch 4
    # over 2 ranks each rank runs it on the same two, so rows are bit-equal
    clips = [os.path.join(WORK_DIR, f"serve{i}.yuv") for i in range(len(SERVE_FRAMES))]
    predict_argv = ["--videos", *clips, "--width", str(W), "--height", str(H), "--framerate", "4",
                    "--model", "seeded", "--imputer", "none", "--scaler", "none", "--device", "cuda:0"]
    with extraction_instruments():
        one_predict = run_predict_batch([*predict_argv, "--batch", "2"])
    torch.cuda.empty_cache()
    ranks = run_ranks(_mesh_cli_rank, 2, argv, outputs, [*predict_argv, "--batch", "4", "--n-data", "2"])
    line = json.loads(ranks[0]["cold"]["stdout"].strip().splitlines()[-1])
    want_line = {"dataset": "live_qualcomm", "mode": "full", "shape": [N_EXTRACT, TOTAL_FEATURE_DIM],
                 "mesh": {"data": 2, "model": 1}}
    if line != want_line or ranks[1]["cold"]["stdout"]:
        raise AssertionError(f"(b) rank 0 printed {line}, rank 1 {ranks[1]['cold']['stdout']!r}")
    mat = np.load(os.path.join(outputs[0], "live_qualcomm_features.npy"))
    equal = bool(np.array_equal(mat, full1080))
    per_rank = [r["cold"]["launches"] for r in ranks]
    total = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
    one, one_process_ms_per_video = one_process["launches"], one_process["warm_ms_per_video"]
    warm_s = max(r["warm"]["s"] for r in ranks)
    out["b"] = {"launches_per_rank": per_rank, "launches_total": total, "matrix_equals_one_process": equal,
                "warm_s": [r["warm"]["s"] for r in ranks], "cold_s": [r["cold"]["s"] for r in ranks],
                "warm_ms_per_video": warm_s * 1e3 / N_EXTRACT,
                "one_process_warm_ms_per_video": one_process_ms_per_video}
    print(f"  (b) launches per rank {per_rank}, summed {total} (one process {one}); matrix equal to phase 8's "
          f"one-process run bit for bit: {equal}")
    print(f"  (b) warm run: {out['b']['warm_ms_per_video']:.2f} ms a video over 2 ranks sharing the card "
          f"(one process, phase 8: {one_process_ms_per_video:.2f}); cold run {out['b']['cold_s']} s per rank")
    if total != one or not equal:
        raise AssertionError(f"(b) the sharded extract differs from the one-process run: {out['b']}")
    per_rank = [r["predict"]["launches"] for r in ranks]
    total = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
    printed = [json.loads(line) for line in ranks[0]["predict"]["stdout"].splitlines()]
    same = [r["predict"]["rows"] == one_predict["rows"] for r in ranks]
    out["b"]["predict_batch"] = {"rows": one_predict["rows"], "rows_equal_one_process": same,
                                 "launches_per_rank": per_rank, "launches_total": total,
                                 "one_process_launches": one_predict["launches"]}
    print(f"  (b) predict-batch --batch 4 --n-data 2 on phase 6's {len(clips)} 540p clips: rows of each rank "
          f"equal to the one-process run's at --batch 2 bit for bit: {same}; launches per rank {per_rank}, "
          f"summed {total} (one process {one_predict['launches']}); MOS {[m for _, m in one_predict['rows']]}")
    if not (all(same) and total == one_predict["launches"] and ranks[1]["predict"]["stdout"] == ""
            and [(x["video"], x["predicted_mos"]) for x in printed] == [tuple(r) for r in one_predict["rows"]]
            and all(math.isfinite(m) for _, m in one_predict["rows"])):
        raise AssertionError(f"(b) the sharded predict-batch differs from the one-process run: "
                             f"{out['b']['predict_batch']}, rank 1 printed {ranks[1]['predict']['stdout']!r}")
    lap("b")

    print(f"  (c) 2 x 2 DP x TP on four ranks (cuda:0, gloo): {TP_STEPS} steps at {FEAT_D} x 256, "
          f"batch {HEAD_BATCH}")
    data_path, state_path = os.path.join(MESH_DIR, "head.pt"), os.path.join(MESH_DIR, "dp_tp_state.pt")
    torch.save({k: ref[k] for k in ("init", "x", "y")}, data_path)
    ranks = run_ranks(_dp_tp_rank, 4, data_path, state_path)
    state = torch.load(state_path, weights_only=False)
    w1 = state.pop("fc1.weight")
    state["fc1.weight"] = w1[:, :FEAT_D]
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["loss"], ref["losses"], strict=True))
    param_rel = {k: rel_err(state[k], v)[1] for k, v in ref["state"].items()}
    out["c"] = {"ranks": ranks, "loss_rel": loss_rel, "param_rel": param_rel,
                "pad_rows": int(w1.shape[1] - FEAT_D), "pad_zero": bool(not w1[:, FEAT_D:].any())}
    print(f"  (c) ranks (rank, data, model): {[r['mesh'] for r in ranks]}; losses {ranks[0]['loss']} "
          f"(one process {ref['losses']}); largest relative difference: loss {loss_rel:.3e}, parameters "
          f"{max(param_rel.values()):.3e} (bound {DP_RTOL:.0e}); fc1 pad rows {out['c']['pad_rows']}, zero: "
          f"{out['c']['pad_zero']}")
    if not (loss_rel <= DP_RTOL and max(param_rel.values()) <= DP_RTOL and out["c"]["pad_zero"]
            and out["c"]["pad_rows"] == 1 and all(r["pad_zero"] for r in ranks)):
        raise AssertionError(f"(c) the DP x TP step differs from the one-process step: {out['c']}")
    lap("c")

    print("  (d) a CUDA index past the device count")
    try:
        resolve_device(f"cuda:{torch.cuda.device_count()}")
    except ValueError as e:
        out["d"] = str(e)
        print(f"  (d) resolve_device('cuda:{torch.cuda.device_count()}') raised: {e}")
        if f"{torch.cuda.device_count()} CUDA device" not in str(e):
            raise AssertionError(f"(d) the refusal does not name the device count: {e}")
    else:
        raise AssertionError("(d) an index past the device count was accepted")
    shutil.rmtree(MESH_DIR)
    lap("d")
    lap.show("phase 10")
    return out




# ------------------------------------------------------------------ phase 11
TOOLS_DIR = os.path.join(WORK_DIR, "tools")
SUM_TOL = {"bf16": 2.0 ** -8, "f32": 1e-5}  # |row sum - 1| of the attention matrix: bf16 rounds each entry by 2^-9


def run_cli_json(argv: list) -> tuple[int, dict]:
    """(exit code, the JSON that ``cli.main(argv)`` prints)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc or 0, json.loads(buf.getvalue())


def probe_pil() -> str | None:
    """PIL's version, or None where it does not import (the oracle of
    ``parity --check features`` resizes with PIL)."""
    try:
        import PIL
    except ImportError:
        return None
    return PIL.__version__


def run_tools() -> dict:
    """Phase 11: ``visualize`` and ``parity`` at full width on the card."""
    os.makedirs(TOOLS_DIR, exist_ok=True)
    lap = Laps()
    out = {"seconds": lap.seconds}

    import cv2

    from relaxtpu_torch import parity as parity_mod
    from relaxtpu_torch import visualize as visualize_mod

    frames = synthetic_bgr(2, H, W, seed=60).cpu().numpy()
    f0, f1 = os.path.join(TOOLS_DIR, "f0.png"), os.path.join(TOOLS_DIR, "f1.png")
    cv2.imwrite(f0, frames[0])
    cv2.imwrite(f1, frames[1])
    residual = np.abs(frames[0].astype(np.int32) - frames[1].astype(np.int32)).astype(np.uint8)
    want_positions = visualize_mod.fragment_positions(residual, device="cpu")
    seen = {}
    real_attn, real_pos, real_build = (visualize_mod.last_selfattention, visualize_mod.fragment_positions,
                                       cli._build_extractor)

    def attn_spy(vit, img):
        seen["img"], seen["attn"] = img, real_attn(vit, img)
        return seen["attn"]

    def pos_spy(*a, **k):
        seen["positions"] = real_pos(*a, **k)
        return seen["positions"]

    rs, vs = seeded_states(vit_depth=12)
    cls_maps = {}
    cpu_vit = ViT(depth=12)
    cpu_vit.load_state_dict(vs)
    cpu_vit.eval()
    references = {}

    def vit_reference(hw: tuple) -> tuple:
        """A seeded (1, 3, h, w) image in [0, 1] and the f32 CPU ViT's tokens of it."""
        if hw not in references:
            x = synthetic_bgr(1, *hw, seed=61 + [(240, 256), (256, 256), (384, 384)].index(hw)).cpu().flip(-1).float() / 255.0
            x = x.permute(0, 3, 1, 2).contiguous()
            with torch.inference_mode():
                references[hw] = (x, cpu_vit.tokens(x))
        return references[hw]

    print(f"  (a) visualize through cli.main on a seeded {H}x{W} PNG pair, ViT-B/16 depth 12")
    visualize_mod.last_selfattention, visualize_mod.fragment_positions = attn_spy, pos_spy
    try:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            fx = FeatureExtractor(rs, vs, dtype=dtype, vit_depth=12, device="cuda")
            cli._build_extractor = lambda args, _fx=fx: _fx
            overlay = os.path.join(TOOLS_DIR, tag)
            times, launches = [], []
            for _ in range(3):
                reset_counts()
                t0 = time.perf_counter()
                rc, line = run_cli_json(["visualize", "--frame", f0, "--next-frame", f1, "--output", overlay,
                                         f"--{tag}"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                launches.append(counts())
            img = cv2.imread(line["overlay"])
            attn = seen["attn"]
            vit_t = timed(lambda: real_attn(fx.vit, seen["img"]))
            split = {  # warm ms of a call's parts: the two PNG reads, the ViT, the overlay's PNG write
                "read_pngs": timed(lambda: (cv2.imread(f0), cv2.imread(f1)))["ms_median"],
                "vit": vit_t["ms_median"], "vit_busy_share": vit_t["busy_share"],
                "write_png": timed(lambda: cv2.imwrite(os.path.join(TOOLS_DIR, "w.png"), img))["ms_median"],
            }
            row_err = float(np.abs(attn.astype(np.float64).sum(-1) - 1).max())
            cls_maps[tag] = visualize_mod.cls_patch_attention(attn).reshape(-1).astype(np.float64)
            r = {"rc": rc, "line": line, "overlay_shape": list(img.shape) if img is not None else None,
                 "positions_equal_cpu": seen["positions"] == want_positions, "launches": launches,
                 "attn_shape": list(attn.shape), "row_sum_max_err": row_err, "ms": times,
                 "ms_warm_median": statistics.median(times[1:]), "ms_split": split}
            out[f"a_{tag}"] = r
            print(f"  (a) {tag}: overlay {r['overlay_shape']}, {line['n_patches']} positions equal the CPU's: "
                  f"{r['positions_equal_cpu']}, launches per call {launches}, attention {r['attn_shape']} rows "
                  f"sum to 1 within {row_err:.2e} (bound {SUM_TOL[tag]:.1e}); ms per call {[round(t, 2) for t in times]}, "
                  f"warm parts {split}")
            if rc != 0 or r["overlay_shape"] != [H, W, 3]:
                raise AssertionError(f"(a) {tag}: no overlay at the frame's shape: {r}")
            if not r["positions_equal_cpu"] or line["n_patches"] != 196:
                raise AssertionError(f"(a) {tag}: the fragment positions differ from the CPU's")
            depth = len(fx.vit.blocks)
            if any(n != {"K1": 0, "K2": 0, "K3": depth - 1} for n in launches):
                raise AssertionError(f"(a) {tag}: expected K3 = {depth - 1} (depth - 1), no K1 or K2, a call; "
                                     f"got {launches}")
            if not row_err <= SUM_TOL[tag]:
                raise AssertionError(f"(a) {tag}: attention rows do not sum to 1: {row_err}")
            # the non-224 position table through K3: 240x256 (241 tokens, the short entry; f32), and
            # 256x256 (257) and 384x384 (577 tokens), the long entry, in both types
            vit_dtype = next(fx.vit.parameters()).dtype
            for hw in (((240, 256),) if tag == "f32" else ()) + ((256, 256), (384, 384)):
                x, want = vit_reference(hw)
                with torch.inference_mode():
                    reset_counts()
                    got = fx.vit.tokens(x.cuda().to(vit_dtype)).float().cpu()
                    torch.cuda.synchronize()
                    n = counts() | slice_counts()
                tokens = (hw[0] // 16) * (hw[1] // 16) + 1
                tr = {"tokens": tokens, "launches": n, "shape_ok": got.shape == want.shape}
                if tag == "f32":
                    tr["rel_err_vs_cpu"] = float((got - want).abs().max() / want.abs().max())
                    ok, what = tr["rel_err_vs_cpu"] <= 1e-4, f"max error / max = {tr['rel_err_vs_cpu']:.2e} (bound 1e-4)"
                else:
                    a64, b64 = got.double().reshape(-1), want.double().reshape(-1)
                    tr["cosine_vs_cpu_f32"] = float(a64 @ b64 / (a64.norm() * b64.norm()))
                    ok, what = tr["cosine_vs_cpu_f32"] >= 0.999, f"cosine {tr['cosine_vs_cpu_f32']:.6f} (bound 0.999)"
                out.setdefault("tokens", {}).setdefault(f"{hw[0]}x{hw[1]}", {})[tag] = tr
                print(f"  (a) {tag} ViT tokens at {hw[0]}x{hw[1]} ({tokens} tokens, the position table resized): "
                      f"CUDA vs CPU f32 {what}, launches {n}")
                long = depth if tokens > attention_mod.SHORT_TOKENS else 0
                want_n = {"K1": 0, "K2": 0, "K3": depth, "K2_generic": 0, "K2_wide": 0, "K3_long": long}
                if not ok or not tr["shape_ok"] or n != want_n:
                    raise AssertionError(f"(a) {tag} non-224 tokens at {hw}: {tr} (launches expected {want_n})")
            del fx
            torch.cuda.empty_cache()
    finally:
        visualize_mod.last_selfattention, visualize_mod.fragment_positions = real_attn, real_pos
        cli._build_extractor = real_build
    a, b = cls_maps["bf16"], cls_maps["f32"]
    out["a_cls_cosine_bf16_f32"] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    print(f"  (a) CLS attention map, cosine(bf16, f32) = {out['a_cls_cosine_bf16_f32']:.6f} (bound 0.999)")
    if not out["a_cls_cosine_bf16_f32"] >= 0.999:
        raise AssertionError(f"(a) the bf16 CLS map drifts from f32: {out['a_cls_cosine_bf16_f32']}")
    lap("a")

    print("  (b) production_numerics() on the card: flow against cv2, bf16 against f32")
    per_flow = len(pyramid_levels(120, 160)) * FARNEBACK_PARAMS["iterations"]
    reset_counts()
    prod = parity_mod.production_numerics()
    prod["launches"] = counts()
    out["b"] = prod
    print(f"  (b) flow mean {prod.get('flow_mean_err_px')} px, p99 {prod.get('flow_p99_err_px')} px (bounds 5e-3, "
          f"5e-2); bf16 cosine {prod['bf16_cosine']!r}, median relative error {prod['bf16_median_rel']!r} (bounds "
          f"0.9999, 5e-2); launches {prod['launches']}")
    want_prod = {"K1": 3 * per_flow, "K2": 3 * per_flow, "K3": 24}
    if not (prod.get("flow_ok") and prod["bf16_ok"] and prod["ok"]) or prod["launches"] != want_prod:
        raise AssertionError(f"(b) production numerics: {prod} (launches expected {want_prod})")
    lap("b")

    out["pil"] = probe_pil()
    print(f"  (c) PIL: {out['pil'] or 'does not import'}")
    if out["pil"] is None:
        print("  (c), (d) the features check's reference resizes with PIL, absent here: CPU host only")
    else:
        print("  (c) parity --check features on the card (f32); its reference on the CPU")
        reset_counts()
        rc, feats = run_cli_json(["parity", "--check", "features", "--device", "cuda"])
        feats["launches"] = counts()
        out["c"] = {"rc": rc, **feats}
        for seg, r in feats["segments"].items():
            print(f"  (c) {seg}: cosine {r['cosine']:.8f}, mean relative error "
                  f"{r['mean_abs_err_over_mean_abs']:.3e}")
        print(f"  (c) ok {feats['ok']}, exit code {rc}, launches {feats['launches']}")
        if rc != 0 or not feats["ok"] or feats["launches"] != {"K1": per_flow, "K2": per_flow, "K3": 12}:
            raise AssertionError(f"(c) feature parity: {out['c']}")
        lap("c")

        print("  (d) parity --check all with no blobs")
        reset_counts()
        rc, all_ = run_cli_json(["parity", "--check", "all", "--device", "cuda"])
        launches = counts()
        out["d"] = {"rc": rc, "ran": all_["ran"], "ok": all_["ok"], "launches": launches,
                    "skipped": {k: v["skipped"] for k, v in all_["checks"].items() if "skipped" in v}}
        print(f"  (d) ran {all_['ran']}, ok {all_['ok']}, exit code {rc}, skipped {out['d']['skipped']}, "
              f"launches {launches}")
        head, demo = out["d"]["skipped"].get("head", ""), out["d"]["skipped"].get("demo", "")
        if (rc, all_["ran"], all_["ok"]) != (0, 2, True) or "--features-mat" not in head or "--video" not in demo:
            raise AssertionError(f"(d) parity --check all: {out['d']}")
        lap("d")
    shutil.rmtree(TOOLS_DIR)
    lap.show("phase 11")
    return out


# ------------------------------------------------------------------ phase 12
K4_WINDOW, K4_SHIFT, K4_VIEWS = (8, 7, 7), (4, 3, 3), 4
# FAST-VQA's stages at 4 views of 32x224x224: token grid, heads, mini-patch side in tokens (0: no gate)
K4_STAGES = (((16, 56, 56), 3, 8), ((16, 28, 28), 6, 4), ((16, 14, 14), 12, 2), ((16, 7, 7), 24, 0))
K4_BLOCKS = (2, 2, 6, 2)  # blocks a stage, half of them shifted
# edges: windows that are not multiples of 16 tokens, one of 512 (K4's largest), several windows an axis
K4_EDGES = (((2, 14, 14), (2, 7, 7), 2, 4), ((4, 14, 21), (1, 7, 7), 2, 7), ((4, 6, 10), (2, 3, 5), 3, 1),
            ((8, 8, 16), (8, 8, 8), 1, 2), ((2, 7, 7), (2, 7, 7), 2, 0))
# |K4 - plain in f32| / max |plain|: K4 rounds P to bf16 before P V and its output to bf16 (2^-9
# relative each), and its exponential is ex2.approx (2 ulp); a bf16 rounding of the f32 plain output
# alone reads ~4e-3, so 1e-2 leaves room for the P rounding and nothing for a wrong index, gate or mask
# (each moves outputs by the size of a bias table entry, ~1)
TOL["K4"] = 1e-2


def k4_bound(views: int, grid, heads: int, window=K4_WINDOW) -> tuple[float, str]:
    """q, k, v read and o written once (bf16) at the memory rate, or QK^T
    and P V (4 B H N^2 D over the windows) at the bf16 peak."""
    n, tokens = math.prod(window), views * math.prod(grid)
    return bound(4 * tokens * heads * 32 * 2, 4.0 * tokens * heads * n * 32, torch.bfloat16)


def k4_inputs(gen: torch.Generator, views: int, grid, heads: int, gated: bool) -> tuple:
    qkv = nan_padded(torch.randn((views, math.prod(grid), 3 * heads * 32), generator=gen, device="cuda")
                     .to(torch.bfloat16))
    rows = window_attention.table_rows(K4_WINDOW)
    return qkv, [torch.randn((rows, heads), generator=gen, device="cuda") for _ in range(1 + gated)]


def check_window_attention(gen: torch.Generator) -> dict:
    """K4 against its plain version in f32 (``window_mha_plain`` on the same
    bf16 qkv) at FAST-VQA's four stage geometries (4 views), unshifted and
    shifted, and at the edges of ``K4_EDGES``, each input at the start of a
    NaN-filled allocation; each call launches K4 once."""
    worst, floor = 0.0, 0.0
    cases = []
    for grid, heads, patch in K4_STAGES:
        for shift in ((0, 0, 0), K4_SHIFT):
            window, sh = window_attention.effective_window(grid, K4_WINDOW, shift)
            cases.append((K4_VIEWS, grid, window, sh, heads, patch))
    for grid, window, heads, patch in K4_EDGES:
        for shift in ((0, 0, 0), tuple(w // 2 for w in window)):
            cases.append((2, grid, window, shift, heads, patch))
    for views, grid, window, shift, heads, patch in cases:
        qkv = nan_padded(torch.randn((views, math.prod(grid), 3 * heads * 32), generator=gen, device="cuda")
                         .to(torch.bfloat16))
        rows = window_attention.table_rows(window)
        tables = [torch.randn((rows, heads), generator=gen, device="cuda") for _ in range(1 + bool(patch))]
        want = window_attention.window_mha_plain(qkv.float(), grid, window, shift, heads, tables, patch, 32**-0.5)
        n0 = window_attention.window_mha.launches
        got = window_attention.window_mha(qkv, grid, window, shift, heads, tables, patch, 32**-0.5)
        err, rel = rel_err(got, want)
        floor = max(floor, rel_err(want.to(torch.bfloat16), want)[1])
        check(f"K4 {views} views, grid {grid}, window {window}, shift {shift}, {heads} heads, mini-patch {patch}",
              rel, TOL["K4"], verbose=False)
        if window_attention.window_mha.launches - n0 != 1:
            raise AssertionError("K4 did not launch once")
        worst = max(worst, rel)
    print(f"  K4 at FAST-VQA's 4 stages (unshifted and shifted) and {len(K4_EDGES)} edge geometries: largest "
          f"|K4 - plain f32| / max |plain| {worst:.3e} (the plain output rounded to bf16: {floor:.3e}; tolerance "
          f"{TOL['K4']:.0e})")
    return {"K4": worst, "K4_bf16_rounding": floor}


def time_window_attention(gen: torch.Generator) -> dict:
    """Each stage's K4 call (4 views, the shifted block) by events and by the
    profiler's device time, beside its bound and the plain version; the sum
    over the 12 calls of a view batch (half of each stage's blocks shifted)."""
    out, total = {}, {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
    for (grid, heads, patch), blocks in zip(K4_STAGES, K4_BLOCKS):
        row = {}
        for shift in ((0, 0, 0), K4_SHIFT):
            window, sh = window_attention.effective_window(grid, K4_WINDOW, shift)
            qkv, tables = k4_inputs(gen, K4_VIEWS, grid, heads, bool(patch))
            fn = lambda: window_attention.window_mha(qkv, grid, window, sh, heads, tables, patch, 32**-0.5)  # noqa: E731
            ms, dev = cuda_ms(fn), device_ms([fn])
            row["shifted" if any(sh) else "unshifted"] = {"ms": ms, "device_ms": dev}
            total["ms"] += ms * blocks / 2
            total["device_ms"] += (dev if dev is not None else ms) * blocks / 2
        b_ms, by = k4_bound(K4_VIEWS, grid, heads)
        row |= {"bound_ms": b_ms, "bound_by": by,
                "plain_ms": cuda_ms(lambda: window_attention.window_mha_plain(
                    qkv, grid, window, sh, heads, tables, patch, 32**-0.5), iters=2, warmup=1)}
        total["bound_ms"] += b_ms * blocks
        dev = row["shifted"]["device_ms"] or row["shifted"]["ms"]
        print(f"  K4 stage grid {grid}, {heads} heads: unshifted {row['unshifted']['ms']:.4f} ms "
              f"(device {row['unshifted']['device_ms']}), shifted {row['shifted']['ms']:.4f} ms (device "
              f"{row['shifted']['device_ms']}); bound {b_ms:.4f} ms ({by}), {100 * b_ms / dev:.1f}% of it; plain "
              f"{row['plain_ms']:.2f} ms")
        out[str(grid)] = row
    total["share"] = total["bound_ms"] / total["device_ms"]
    print(f"  K4, the 12 calls of a view batch: {total['ms']:.4f} ms by events, {total['device_ms']:.4f} device ms, "
          f"bound {total['bound_ms']:.4f} ms ({100 * total['share']:.1f}%)")
    return out | {"view_batch": total}


def run_window_attention() -> dict:
    """Phase 12: K4 and FAST-VQA's program on the card."""
    lap = Laps()
    gen = torch.Generator(device="cuda").manual_seed(12)
    res = {"check": check_window_attention(gen)}
    lap("K4 checks")
    res["timing"] = time_window_attention(gen)
    lap("K4 timing")

    # (b) the program at 540p: the host crop, the mosaic, 12 K4 launches a video, the reference
    h, w, n = 540, 960, 192
    idx = fastvqa_mod.clip_indices(n)
    flat = sorted({i for c in idx for i in c})
    i420 = bgr_to_i420(synthetic_bgr(len(flat), h, w, seed=12))
    pos = {t: k for k, t in enumerate(flat)}
    clips = [i420[[pos[t] for t in c]] for c in idx]
    offsets = fastvqa_mod.draw_offsets(np.random.default_rng(12), h, w)
    tops, lefts, _, _ = fastvqa_mod.region_plan(h, w, offsets)
    shape = (len(clips[0]), fastvqa_mod.PATCHES, fastvqa_mod.REGION_BYTES)
    a, b = np.empty(shape, np.uint8), np.empty(shape, np.uint8)
    t_native, t_plain = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for k in range(len(clips)):
            fastvqa_mod.crop_i420(clips[k], h, w, tops[k], lefts[k], a, True)
        t_native.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for k in range(len(clips)):
            fastvqa_mod.crop_i420(clips[k], h, w, tops[k], lefts[k], b, False)
        t_plain.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(a, b):
            raise AssertionError("the host crop routine differs from crop_i420_plain")
    res["crop_host_ms"] = {"native": min(t_native), "plain": min(t_plain)}
    print(f"  host crop of a 540p video (4 clips x 32 frames x 49 regions): library routine "
          f"{min(t_native):.2f} ms, numpy {min(t_plain):.2f} ms (best of 3), bit-identical")

    state = random_state(12)
    fx = FastVQAExtractor(state, torch.bfloat16, "cuda")
    ref = reference_fastvqa.Reference(state, "cuda")
    mosaic = fx.mosaic_i420(clips, h, w, offsets)
    want = ref.mosaic(clips, h, w, offsets)
    if not torch.equal(mosaic, want):
        raise AssertionError("the program's mosaic differs from the reference's whole-frame conversion and crop")
    print("  the program's mosaic equals the reference's (whole frames converted, then cropped): bit-identical")
    with torch.inference_mode():  # the same stages launched eagerly, the graphs' yardstick
        eager_vec = fx._score(fx.mosaic_i420(clips, h, w, offsets))[0].cpu().numpy()
    fx.finish(fx.enqueue_i420(clips, h, w, offsets))  # warm: captures the graphs
    torch.cuda.synchronize()
    n0 = window_attention.window_mha.launches
    torch.cuda.reset_peak_memory_stats()
    with no_sync():  # the second enqueue launches the first video's program (its regions cut meanwhile)
        handle = fx.enqueue_i420(clips, h, w, offsets)
        second = fx.enqueue_i420(clips, h, w, offsets)
    launches = window_attention.window_mha.launches - n0
    vec, score = fx.finish(handle)
    fx.finish(second)
    graph_gap = float(np.abs(vec - eager_vec).max() / np.abs(eager_vec).max())
    print(f"  the CUDA-graph program against the eager one: max |difference| / max |eager| {graph_gap:.3e}")
    if graph_gap > 1e-2:
        raise AssertionError("the CUDA-graph program's answer differs from the eager program's")
    if launches != 12:
        raise AssertionError(f"K4 launched {launches} times for a video, not 12")
    peak = torch.cuda.max_memory_allocated()
    res["program"] = {"k4_launches": launches, "peak_bytes": peak, "graph_against_eager": graph_gap, **timed(
        lambda: fx.finish(fx.enqueue_i420(clips, h, w, offsets)))}
    scores_ref, feat_ref, score_ref = ref.answer(clips, h, w, offsets)
    ref8 = reference_fastvqa.Reference(state, "cuda", "fp8")
    readings = {}
    for tag, (s_r, f_r, sc_r) in (("bf16 program", (vec[:scores_ref.size], vec[scores_ref.size:], score)),
                                  ("fp8 control", ref8.answer(clips, h, w, offsets))):
        s_r, f_r = np.asarray(s_r).reshape(scores_ref.shape), np.asarray(f_r).reshape(feat_ref.shape)
        readings[tag] = {
            "head_map": float(np.linalg.norm(s_r - scores_ref) / np.linalg.norm(scores_ref)),
            "feat": max(float(np.linalg.norm(f_r[v] - feat_ref[v]) / np.linalg.norm(feat_ref[v]))
                        for v in range(len(feat_ref))),
            "score": abs(float(sc_r) - score_ref)}
        print(f"  {tag} against the f32 reference: {readings[tag]}")
    res["program"] |= {"readings": readings, "score": score, "score_ref": score_ref}
    print(f"  FAST-VQA program at 540p (bf16, 4 views of 32x224x224): K4 {launches} launches a video; "
          f"{res['program']['ms_median']:.2f} ms a video (enqueue and fetch); peak {peak} B; score {score:.4f} "
          f"(reference {score_ref:.4f})")
    lap("program")
    lap.show("phase 12")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase = Laps()  # seconds by phase; phases 3-11 also keep theirs by step
    card = gpu_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"host RAM {host_ram_bytes()} B, {os.cpu_count()} CPUs")
    phase("1 card")

    t0 = time.perf_counter()
    _native.lib()
    build_s = time.perf_counter() - t0
    print(f"[2] kernels built and loaded in {build_s:.1f} s")
    build_info = report_build(_native.build())
    phase("2 build")
    if sys.argv[1:] == ["pyramid"]:  # phases 1 and 2, the pyramid's checks and times, the flow's live planes
        print("[3] the pyramid kernel against its plain version; each level timed; the flow with it and without")
        gen = torch.Generator(device="cuda").manual_seed(0)
        res = {"check": check_pyramid_level(gen), "timing": time_pyramid_levels(), "flow_live_planes_1080p":
               flow_live_planes()}
        phase("3 pyramid")
        print(f"[13] seconds by phase: { {k: round(v, 1) for k, v in phase.seconds.items()} }")
        os.makedirs(WORK_DIR, exist_ok=True)
        with open(os.path.join(WORK_DIR, "chip_smoke_pyramid.json"), "w") as fh:
            json.dump({"card": card, "torch": torch.__version__, "build": build_info, "pyramid": res}, fh, indent=1)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["k4"]:  # phases 1, 2 and 12 alone
        print("[12] K4 and FAST-VQA's program (540p, 4 views of 32x224x224, bf16)")
        k4 = run_window_attention()
        phase("12 K4")
        print(f"[13] seconds by phase: { {k: round(v, 1) for k, v in phase.seconds.items()} }")
        os.makedirs(WORK_DIR, exist_ok=True)
        with open(os.path.join(WORK_DIR, "chip_smoke_k4.json"), "w") as fh:
            json.dump({"card": card, "torch": torch.__version__, "build": build_info, "k4": k4}, fh, indent=1)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    print("[3] kernels against their plain versions (540p, 1080p and 4K shapes)")
    lap3 = Laps()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stress = check_flow_kernels(gen)
    lap3("K1 and K2 stress shapes")
    stress["PE"] = check_poly_expansion(gen)
    lap3("expansion stress shapes")
    pyramid_check = check_pyramid_level(gen)
    stress["PY"] = pyramid_check["max_abs_err"]
    pyramid_timing = time_pyramid_levels()
    lap3("pyramid stress shapes, levels and flow")
    stress |= check_attention_kernel(gen)
    torch.cuda.synchronize()
    lap3("K3 stress shapes")
    flow_mem = flow_live_planes()
    lap3("flow live planes")
    long_attn = time_long_attention(gen)
    lap3("long K3 timing")
    wide_flow = check_wide_flow(WIDE_WINSIZE)
    pair_flow = check_wide_flow(PAIR_WINSIZE)
    lap3("wide-window flow")
    lap3.show("phase 3")
    phase("3 kernels")

    print("[4] CUDA run against CPU run (2 frames, 240x320, depth-2 ViT, f32)")
    cos_cpu = check_cuda_vs_cpu()
    phase("4 CUDA vs CPU")

    print("[5] main path: 540x960, 16 frames + 16 pairs, ResNet-50 + ViT-B/16 depth 12")
    main_res, vec540 = run_main_path()
    phase("5 main path")

    print("[6] serving paths: batched, streamed, 1080p chunked, serve loop")
    serving, streamed540 = run_serving()
    phase("6 serving")

    print("[7] training the MLP head at full width: train, CUDA vs CPU, train-lsvq, finetune")
    training = run_training(vec540)
    phase("7 training")

    print("[8] extraction: extract in every mode at 1080p, CUDA vs CPU, VGG-16, --profile-dir")
    extraction, full1080 = run_extraction()
    phase("8 extraction")

    print("[9] ingest: BGR against I420, predict_arrays, predict_batch grouping, no pairs, decoder, warmup")
    ingest = run_ingest()
    phase("9 ingest")

    print("[10] multi-device: world size 1 under NCCL, 2 and 4 ranks sharing the card through gloo")
    mesh = run_mesh(streamed540, full1080, extraction["a"])
    phase("10 multi-device")

    print("[11] tools: visualize, production numerics, parity --check features and all, full width")
    tools = run_tools()
    phase("11 tools")

    print("[12] K4 and FAST-VQA's program (540p, 4 views of 32x224x224, bf16)")
    k4 = run_window_attention()
    phase("12 K4")
    print(f"[13] seconds by phase: { {k: round(v, 1) for k, v in phase.seconds.items()} }, "
          f"total {sum(phase.seconds.values()):.1f}")

    sources = {"K1": ("update_matrices", "relaxtpu_torch/csrc/warp.cu", "relaxtpu/ops/warp.py:234"),
               "K2": ("box_blur_solve", "relaxtpu_torch/csrc/boxsolve.cu", "relaxtpu/ops/boxsolve.py:47"),
               "K3": ("mha", "relaxtpu_torch/csrc/attention.cu", "relaxtpu/ops/attention.py:34"),
               "PE": ("poly_expansion", "relaxtpu_torch/csrc/polyexp.cu",
                      "no Pallas kernel (relaxtpu/ops/flow.py::_poly_expansion is left to XLA)"),
               "PY": ("pyramid_level", "relaxtpu_torch/csrc/pyramid.cu",
                      "no Pallas kernel (the pyramid of relaxtpu/ops/flow.py is left to XLA)")}
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
            "source": src, "replaces": rep,
            "launches": main_res[tag]["pe_launches"] if key == "PE" else main_res[tag]["py_launches"] if key == "PY"
            else main_res[tag]["launches"][key],
            "max_abs_err": max([r["err"], stress[key if key != "K3" else f"K3_{tag}"]]
                               + [v[key]["err"] for v in serving[tag]["kernels"].values()]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"],
            "serving_shapes": shapes,
        })
    # this slice's entries: launches from their own paths (the ViT at 384x384 in phase 11 (a), the
    # flow at winsize 21 in phase 3), each run with the counts set to 0 just before it
    for tag in ("bf16", "f32"):
        r = long_attn[f"{tag}_{LONG_ATTN_SHAPE[1]}"]
        kernels.append({
            "name": f"K3 mha long entry ({tag}, {LONG_ATTN_SHAPE})", "route": "cuda",
            "source": sources["K3"][1], "replaces": sources["K3"][2],
            "launches": tools["tokens"]["384x384"][tag]["launches"]["K3_long"],
            "max_abs_err": max(r["err"], stress[f"K3_long_{tag}"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
        })
    # the K2 routes past the strip kernel's window, each with launches from its own flow path
    for key, what, path in (("k2_generic", f"generic radius (box_ring_solve_kernel, winsize {WIDE_WINSIZE})",
                             wide_flow),
                            ("k2_wide", f"wide window (box_vsum_kernel + box_hsum_solve_kernel, winsize "
                                        f"{PAIR_WINSIZE})", pair_flow)):
        r, route = main_res["bf16"][key], key.replace("k2", "K2")
        kernels.append({
            "name": f"K2 box_blur_solve {what}", "route": "cuda",
            "source": sources["K2"][1], "replaces": sources["K2"][2],
            "launches": path["launches"][route], "max_abs_err": max(r["err"], stress[route]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "device_ms": r["device_ms"], "library_device_ms": None,
        })

    k4_total = k4["timing"]["view_batch"]
    kernels.append({
        "name": "K4 window_mha (bf16, FAST-VQA's 12 calls of 4 views)", "route": "cuda",
        "source": "relaxtpu_torch/csrc/window_attention.cu", "replaces": "no Pallas kernel (added for FAST-VQA)",
        "launches": k4["program"]["k4_launches"], "max_abs_err": k4["check"]["K4"],
        "ms": k4_total["ms"], "plain_ms": None, "bound_ms": k4_total["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": k4_total["device_ms"], "library_device_ms": None,
    })
    with open(os.path.join(WORK_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_s": build_s, "build": build_info, "kernels": kernels,
                   "seconds": {"phases": phase.seconds, "phase_3": lap3.seconds},
                   "stress_max_abs_err": stress,
                   "flow_live_planes_1080p": flow_mem, "cuda_vs_cpu_cosine": cos_cpu,
                   "pyramid_check": pyramid_check, "pyramid_timing": pyramid_timing,
                   "long_attention": long_attn, "wide_window_flow": wide_flow, "pair_window_flow": pair_flow,
                   "main_path": main_res, "serving": serving, "training": training,
                   "extraction": extraction, "ingest": ingest, "mesh": mesh, "tools": tools, "k4": k4}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CPU runs of the port's training at reduced sizes: a rehearsal of
``chip_smoke.py``'s phase 7, and a probe of the LSVQ head's learning.

    # phase 7 on the CPU at width 2,048 (LSVQ shape cut to 2,000 + 500 rows)
    python scripts/torch_train_rehearsal.py rehearse --width 2048
    # the LSVQ configuration (no BN, lr 1e-2, k-fold off, 20 epochs) on
    # chip_smoke's seeded features: validation losses and test SRCC
    python scripts/torch_train_rehearsal.py lsvq --width 35203 --rows 2500
    python scripts/torch_train_rehearsal.py lsvq --width 4096 --rows 28056 --lr 0.086

The rehearsal replaces the CUDA-only pieces of phase 7 (events, memory
statistics, the sync debug mode, the profiler's device activity) with host
stand-ins, so every number it prints is a host number.  Files go under
``build/rehearsal``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import relaxtpu_torch.predict as predict_mod  # noqa: E402
from relaxtpu_torch.model import protocol, train  # noqa: E402
from relaxtpu_torch.model.metrics import compute_correlation_metrics  # noqa: E402
from relaxtpu_torch.model.mlp import Mlp  # noqa: E402


class HostEvent:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def rehearse(width: int) -> None:
    cs.TRAIN_DEVICE = "cpu"
    cs.FEAT_D = width
    cs.LSVQ_TRAIN_N, cs.LSVQ_TEST_N = 2000, 500
    cs.TRAIN_DIR = os.path.join(ROOT, "build", "rehearsal", "train")
    predict_mod.Mlp = functools.partial(Mlp, width)
    torch.cuda.Event = HostEvent
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    cs.no_sync = contextlib.nullcontext
    profile = torch.profiler.profile
    torch.profiler.profile = lambda activities=None, **kw: profile(
        activities=[torch.profiler.ProfilerActivity.CPU], **kw)
    t0 = time.perf_counter()
    cs.run_training(np.random.default_rng(0).normal(size=width).astype(np.float32))
    print(f"rehearsal at width {width}: {time.perf_counter() - t0:.1f} s")


def lsvq(width: int, rows: int, lr: float) -> None:
    cs.TRAIN_DEVICE = "cpu"
    cs.FEAT_D = width
    x, mos = cs.synthetic_features(rows, seed=2)
    x_te, mos_te = cs.synthetic_features(600, seed=3)
    to100 = lambda m: (m - 1) * 99 / 4 + 1  # noqa: E731
    x, y, _ = protocol.preprocess_like_reference(x, to100(mos))
    x_te, y_te, _ = protocol.preprocess_like_reference(x_te, to100(mos_te))
    cfg = train.TrainConfig(use_bn=False, kfold=False, initial_lr=lr, weight_decay=5e-4,
                            select_criteria="bykrcc")
    snap, trainer, _, val = train.train_and_evaluate(x, y, cfg, device="cpu")
    srcc = compute_correlation_metrics(y_te, trainer.predict(snap, x_te))[3]
    print(f"LSVQ head, width {width}, {rows} rows, lr {lr}: validation losses "
          f"{[round(v, 2) for v in val[0]]}; test SRCC {srcc:.4f}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["rehearse", "lsvq"])
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--rows", type=int, default=2500)
    p.add_argument("--lr", type=float, default=1e-2)
    args = p.parse_args()
    if args.mode == "rehearse":
        rehearse(args.width)
    else:
        lsvq(args.width, args.rows, args.lr)


if __name__ == "__main__":
    main()

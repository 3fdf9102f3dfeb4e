"""Evaluation protocols (counterpart of ``relaxtpu/model/protocol.py:33-310``):
repeated holdout (intra-dataset), the fixed LSVQ / cross-dataset split, and
cross-dataset fine-tuning and zero-shot evaluation.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from relaxtpu_torch.data.mos import mos_1_100_to_1_5, mos_1_5_to_1_100
from relaxtpu_torch.data.splits import split_other, train_test_split
from relaxtpu_torch.device import upload
from relaxtpu_torch.model.metrics import compute_correlation_metrics
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.model.train import (
    MlpTrainer,
    ModelSnapshot,
    RepeatResult,
    TrainConfig,
    make_optimizer,
    reference_lr_sequence,
    select_median_model,
    set_lr,
    state_of,
    swa_update,
    train_and_evaluate,
)
from relaxtpu_torch.utils.checkpoint import load_snapshot, save_snapshot
from relaxtpu_torch.utils.keywords import jax_keywords
from relaxtpu_torch.utils.plots import plot_losses, plot_results

log = logging.getLogger("relaxtpu_torch.protocol")


def preprocess_like_reference(x: np.ndarray, y: np.ndarray):
    """Zero nan/inf, impute, min-max, as the reference's preprocess_data;
    the reference fits train and test scalers independently, and so do the
    callers here."""
    fs = FeatureScaler.fit(x)
    return fs.fit_transform_like_reference(x).astype(np.float32), np.asarray(y, float), fs


@jax_keywords(df="meta")
def run_repeated_holdout(
    meta: dict,
    features: np.ndarray,
    cfg: TrainConfig,
    grey_indices=None,
    progress: Callable[[str], None] = log.info,
    resume_dir: str | None = None,
    device: str | torch.device | None = None,
    artifacts_dir: str | None = None,
) -> tuple[RepeatResult, float, list[RepeatResult]]:
    """n_repeats x {80/20 holdout at random_state ceil(8.8 i) -> k-fold
    training -> test metrics}; the median model.

    ``resume_dir``: each repeat's snapshot and metrics are kept there, and
    repeats found there are not run again.  ``artifacts_dir``: the
    reference's figures, each trained repeat's mean fold losses
    (``losses_repeat_XX.png``) and the median repeat's logistic-fit scatter
    (``median_scatter.png``).
    """
    results: list[RepeatResult] = []
    trainer: MlpTrainer | None = None
    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
    for i in range(1, cfg.n_repeats + 1):
        if resume_dir:
            ck = os.path.join(resume_dir, f"repeat_{i:02d}.npz")
            if os.path.exists(ck):
                data = np.load(ck, allow_pickle=True)  # written below
                results.append(RepeatResult(
                    float(data["srcc"]), float(data["krcc"]), float(data["plcc"]),
                    float(data["rmse"]), list(data["test_vids"]), data["y_test"], data["y_pred"],
                    load_snapshot(os.path.join(resume_dir, f"repeat_{i:02d}_model.npz")),
                ))
                progress(f"repeat {i}: resumed from {ck}")
                continue
        t0 = time.time()
        x_tr, y_tr, x_te, y_te, test_vids = split_other(
            meta, features, test_size=0.2, random_state=math.ceil(8.8 * i), grey_indices=grey_indices)
        x_tr, y_tr, _ = preprocess_like_reference(x_tr, y_tr)
        x_te, y_te, _ = preprocess_like_reference(x_te, y_te)

        snapshot, trainer, tr_losses, val_losses = train_and_evaluate(x_tr, y_tr, cfg, trainer=trainer,
                                                                      device=device)
        if artifacts_dir:
            plot_losses(tr_losses, val_losses, os.path.join(artifacts_dir, f"losses_repeat_{i:02d}.png"),
                        title=f"repeat {i}: mean fold losses")
        y_pred = trainer.predict(snapshot, x_te)
        try:
            _, plcc, rmse, srcc, krcc = compute_correlation_metrics(y_te, y_pred)
        except Exception as e:  # curve_fit failure on a degenerate repeat
            progress(f"repeat {i}: metric fit failed ({e}); recording zeros")
            plcc = rmse = srcc = krcc = 0.0
        results.append(RepeatResult(srcc, krcc, plcc, rmse, list(test_vids), y_te, y_pred, snapshot))
        if resume_dir:
            os.makedirs(resume_dir, exist_ok=True)
            save_snapshot(os.path.join(resume_dir, f"repeat_{i:02d}_model.npz"), snapshot)
            np.savez(os.path.join(resume_dir, f"repeat_{i:02d}.npz"),
                     srcc=srcc, krcc=krcc, plcc=plcc, rmse=rmse,
                     test_vids=np.asarray(list(test_vids), dtype=object), y_test=y_te, y_pred=y_pred)
        progress(f"repeat {i}/{cfg.n_repeats}: SRCC {srcc:.4f} KRCC {krcc:.4f} "
                 f"PLCC {plcc:.4f} RMSE {rmse:.4f} ({time.time() - t0:.1f}s)")

    median_result, median_val, _ = select_median_model(results, cfg.select_criteria)
    progress(f"median test SRCC {np.median([r.srcc for r in results]):.4f} "
             f"({cfg.select_criteria} median {median_val:.4f})")
    if artifacts_dir and len(median_result.y_pred):
        plot_results(median_result.y_test, median_result.y_pred, os.path.join(artifacts_dir, "median_scatter.png"),
                     title=f"median repeat ({cfg.select_criteria} {median_val:.4f})")
    return median_result, median_val, results


def run_fixed_split(x_train, y_train, x_test, y_test, cfg: TrainConfig,
                    progress: Callable[[str], None] = log.info,
                    device: str | torch.device | None = None):
    """A fixed train/test split (LSVQ, cross-dataset) as one repeat ->
    (RepeatResult, trainer).  ``kfold=False, use_bn=False`` is the
    LSVQ-scale 'simple' variant."""
    x_train, y_train, _ = preprocess_like_reference(x_train, y_train)
    x_test, y_test, _ = preprocess_like_reference(x_test, y_test)
    snapshot, trainer, _, _ = train_and_evaluate(x_train, y_train, cfg, device=device)
    y_pred = trainer.predict(snapshot, x_test)
    _, plcc, rmse, srcc, krcc = compute_correlation_metrics(y_test, y_pred)
    progress(f"fixed split: SRCC {srcc:.4f} KRCC {krcc:.4f} PLCC {plcc:.4f} RMSE {rmse:.4f}")
    return RepeatResult(srcc, krcc, plcc, rmse, [], y_test, y_pred, snapshot), trainer


@dataclasses.dataclass
class FineTuneConfig:
    n_repeats: int = 21
    epochs: int = 20
    batch_size: int = 256
    initial_lr: float = 1e-2
    weight_decay: float = 5e-4
    optimizer_type: str = "sgd"
    use_swa: bool = True
    swa_start_frac: float = 0.75
    l1_w: float = 0.6
    rank_w: float = 1.0
    select_criteria: str = "byrmse"
    seed: int = 0


def fine_tune(base_snapshot: ModelSnapshot, trainer: MlpTrainer, x: np.ndarray, y: np.ndarray,
              ft_cfg: FineTuneConfig, mos_is_1_5: bool,
              progress: Callable[[str], None] = log.info) -> tuple[RepeatResult, list[RepeatResult]]:
    """Cross-dataset adaptation: n_repeats x {80/20 split of the target set
    at random_state ceil(8.8 i); fine-tune from the base weights with SWA
    from 75%; evaluate}; the median by the criteria.  1-5 MOS are trained
    on 1-100 and mapped back for the metrics."""
    results: list[RepeatResult] = []
    y100 = mos_1_5_to_1_100(y) if mos_is_1_5 else np.asarray(y, float)
    cfg = TrainConfig(
        epochs=ft_cfg.epochs, batch_size=ft_cfg.batch_size, initial_lr=ft_cfg.initial_lr,
        weight_decay=ft_cfg.weight_decay, optimizer_type=ft_cfg.optimizer_type,
        use_swa=ft_cfg.use_swa, swa_start_frac=ft_cfg.swa_start_frac, l1_w=ft_cfg.l1_w,
        rank_w=ft_cfg.rank_w, select_criteria=ft_cfg.select_criteria, use_bn=trainer.cfg.use_bn,
        hidden_features=trainer.cfg.hidden_features, drop_rate=trainer.cfg.drop_rate,
        kfold=False, seed=ft_cfg.seed,
    )
    ft_trainer = MlpTrainer(cfg, trainer.input_dim, trainer.device)
    x_dev = ft_trainer.to_device(x)
    y_dev = ft_trainer.to_device(y100)
    for i in range(1, ft_cfg.n_repeats + 1):
        rs = math.ceil(8.8 * i)
        idx_tr, idx_te = train_test_split(np.arange(len(x)), test_size=0.2, random_state=rs)
        tr_dev = upload(torch.from_numpy(idx_tr), ft_trainer.device)
        snapshot = _fine_tune_once(base_snapshot, ft_trainer, x_dev.index_select(0, tr_dev),
                                   y_dev.index_select(0, tr_dev), cfg, seed=rs)
        y_pred = ft_trainer.predict(snapshot, x[idx_te])
        y_te = y100[idx_te]
        if mos_is_1_5:
            y_te, y_pred = mos_1_100_to_1_5(y_te), mos_1_100_to_1_5(y_pred)
        _, plcc, rmse, srcc, krcc = compute_correlation_metrics(y_te, y_pred)
        results.append(RepeatResult(srcc, krcc, plcc, rmse, [], y_te, y_pred, snapshot))
        progress(f"ft repeat {i}: SRCC {srcc:.4f} KRCC {krcc:.4f} PLCC {plcc:.4f} RMSE {rmse:.4f}")

    median_result, _, _ = select_median_model(results, ft_cfg.select_criteria)
    return median_result, results


def zero_shot_eval(base_snapshot: ModelSnapshot, trainer: MlpTrainer, x: np.ndarray, y: np.ndarray,
                   ft_cfg: FineTuneConfig, mos_is_1_5: bool,
                   progress: Callable[[str], None] = log.info) -> tuple[RepeatResult, list[RepeatResult]]:
    """The base model, not adapted, scored on the n_repeats test splits of
    the target set."""
    results: list[RepeatResult] = []
    y100 = mos_1_5_to_1_100(y) if mos_is_1_5 else np.asarray(y, float)
    for i in range(1, ft_cfg.n_repeats + 1):
        rs = math.ceil(8.8 * i)
        _, idx_te = train_test_split(np.arange(len(x)), test_size=0.2, random_state=rs)
        y_pred = trainer.predict(base_snapshot, x[idx_te])
        y_te = y100[idx_te]
        if mos_is_1_5:
            y_te, y_pred = mos_1_100_to_1_5(y_te), mos_1_100_to_1_5(y_pred)
        _, plcc, rmse, srcc, krcc = compute_correlation_metrics(y_te, y_pred)
        results.append(RepeatResult(srcc, krcc, plcc, rmse, [], y_te, y_pred, base_snapshot))
        progress(f"zero-shot repeat {i}: SRCC {srcc:.4f} RMSE {rmse:.4f}")
    median_result, _, _ = select_median_model(results, ft_cfg.select_criteria)
    return median_result, results


def _fine_tune_once(base: ModelSnapshot, trainer: MlpTrainer, x_tr, y_tr, cfg: TrainConfig,
                    seed: int) -> ModelSnapshot:
    """One fine-tune run: all epochs from the base weights, no validation;
    the SWA average of the tail with the trained BN buffers, then
    ``update_bn``.  The reference's loader does not shuffle, so every epoch
    sees the same batches."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    model = trainer.train_model(base.state)
    opt = make_optimizer(cfg, model.parameters())
    x_tr, y_tr = trainer.to_device(x_tr), trainer.to_device(y_tr)
    swa_start = int(cfg.epochs * cfg.swa_start_frac) if cfg.use_swa else cfg.epochs
    swa, swa_n = None, 0
    epoch_lrs = reference_lr_sequence(cfg)
    perm = np.arange(len(x_tr))
    for epoch in range(cfg.epochs):
        set_lr(opt, epoch_lrs[epoch])
        trainer.train_epoch(model, opt, x_tr, y_tr, perm, gen)
        if cfg.use_swa and epoch >= swa_start:
            swa, swa_n = swa_update(swa, swa_n, model)
    state = {k: v.clone() for k, v in state_of(model).items()}
    snap = ModelSnapshot({**state, **(swa or {})})
    if cfg.use_swa:
        snap = trainer.update_bn(snap, x_tr, rng)
    return snap

"""Training protocol for the MOS-regression head (counterpart of
``relaxtpu/model/train.py:44-478``), in f32 with TF32 off.

The same protocol as the JAX package, step for step:

- per repeat: k-fold CV (``KFold(shuffle=True, random_state=42)``) or one
  80/20 validation split;
- per fold: a fresh head with flax's init; SGD (momentum 0.9, L2 weight
  decay) or Adam (L2) or AdamW at the reference's coupled Cosine/StepLR +
  SWALR learning-rate sequence (``reference_lr_sequence``); SWA from 70%
  of the epochs as an equal parameter average, evaluated with the
  *initial* BN buffers;
- best-model selection across folds by validation RMSE or KRCC; early
  stopping only once SWA is on, snapshotting the *raw* model;
- after each fold, ``update_bn`` recomputes the BN buffers as a cumulative
  average of unbiased per-batch statistics over a fresh permutation;
- across repeats, the median model by test RMSE/KRCC.

One ``np.random.default_rng(cfg.seed)`` feeds, in order, one
``integers(0, 2**31 - 1)`` a fold (that fold's ``torch.Generator`` for the
init and the dropout masks), one ``permutation`` an epoch and one
``permutation`` in ``update_bn`` a fold, as in the JAX package, so every
batch grouping equals its.

Device placement: the feature matrix goes to the device once; folds are
``index_select``s there; each epoch makes one permuted copy and takes
contiguous batch slices of it (the ragged last batch is kept); the epoch's
summed loss stays on the device and is fetched once an epoch.  The step
loop (``MlpTrainer.epoch_steps``) never synchronises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from relaxtpu_torch.data.splits import kfold_split, train_test_split
from relaxtpu_torch.device import resolve_device, set_strict_f32, upload
from relaxtpu_torch.model.losses import mae_and_rank_loss
from relaxtpu_torch.model.metrics import compute_correlation_metrics
from relaxtpu_torch.model.mlp import Mlp, flax_init_


@dataclasses.dataclass
class TrainConfig:
    n_repeats: int = 21
    n_splits: int = 10
    batch_size: int = 256
    epochs: int = 20
    hidden_features: int = 256
    drop_rate: float = 0.1
    loss_type: str = "MAERankLoss"
    optimizer_type: str = "sgd"  # 'sgd' | 'adam' (L2 Adam) | 'adamw'
    select_criteria: str = "byrmse"  # 'byrmse' | 'bykrcc'
    initial_lr: float = 0.1
    weight_decay: float = 0.005
    patience: int = 5
    use_swa: bool = True
    l1_w: float = 0.6
    rank_w: float = 1.0
    use_bn: bool = True
    kfold: bool = True  # False: one 80/20 validation split
    swa_start_frac: float = 0.7
    swa_anneal_epochs: int = 10
    eta_min: float = 1e-5
    seed: int = 0


def reference_lr_sequence(cfg: TrainConfig, swa_start_frac: float | None = None) -> list[float]:
    """The lr of each epoch of the reference loop, which steps its base
    scheduler (CosineAnnealingLR for sgd, StepLR(2, 0.95) otherwise) every
    epoch and also SWALR(swa_lr=initial_lr, cos) once SWA is on; torch's
    schedulers are recurrences over the current lr, so the two couple."""
    frac = cfg.swa_start_frac if swa_start_frac is None else swa_start_frac
    swa_start = int(cfg.epochs * frac) if cfg.use_swa else cfg.epochs
    k = max(1, cfg.swa_anneal_epochs)
    anneal = lambda t: (1 - math.cos(math.pi * min(max(t, 0.0), 1.0))) / 2  # noqa: E731
    lrs = []
    lr = cfg.initial_lr
    for e in range(cfg.epochs):
        lrs.append(lr)
        if cfg.optimizer_type == "sgd":  # CosineAnnealingLR(T_max=epochs)
            num = 1 + math.cos(math.pi * (e + 1) / cfg.epochs)
            den = 1 + math.cos(math.pi * e / cfg.epochs)
            lr = num / den * (lr - cfg.eta_min) + cfg.eta_min
        elif (e + 1) % 2 == 0:  # StepLR(step_size=2, gamma=0.95)
            lr = lr * 0.95
        if cfg.use_swa and e >= swa_start:  # SWALR.step(), s = 1, 2, ...
            s = e - swa_start + 1
            swa_lr = cfg.initial_lr
            prev_alpha = anneal((s - 1) / k)
            base = swa_lr if prev_alpha == 1 else (lr - prev_alpha * swa_lr) / (1 - prev_alpha)
            alpha = anneal(s / k)
            lr = swa_lr * alpha + base * (1 - alpha)
    return lrs


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """SGD(momentum 0.9) and Adam take the weight decay as L2 on the
    gradient (optax's ``add_decayed_weights`` before the optimiser); AdamW
    decays the weights directly."""
    if cfg.optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=cfg.initial_lr, momentum=0.9, weight_decay=cfg.weight_decay)
    if cfg.optimizer_type == "adam":
        return torch.optim.Adam(params, lr=cfg.initial_lr, weight_decay=cfg.weight_decay)
    return torch.optim.AdamW(params, lr=cfg.initial_lr, weight_decay=cfg.weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class ModelSnapshot:
    """A selected model: the head's parameters and BN running stats, as a
    state dict of ``Mlp`` (``fc1.weight``, ..., ``bn1.running_var``)."""

    state: dict[str, torch.Tensor]


def _clone(state: dict) -> dict:
    return {k: v.detach().clone() for k, v in state.items()}


def state_of(model: Mlp) -> dict[str, torch.Tensor]:
    """The live parameters and running stats of ``model`` (not copies)."""
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def swa_update(swa: dict | None, swa_n: int, model: Mlp) -> tuple[dict, int]:
    """SWA's equal average of the parameters, with ``model``'s as the next."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    if swa is None:
        return _clone(params), 1
    swa_n += 1
    for k, a in swa.items():
        a.add_((params[k] - a) / swa_n)
    return swa, swa_n


def bn_batch_stats(xb: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """Pre-BN activation batch mean and unbiased variance."""
    h = F.linear(xb, weight, bias)
    n = xb.shape[0]
    return h.mean(dim=0), h.var(dim=0, correction=0) * (n / max(n - 1, 1))


class MlpTrainer:
    """The head's train and eval programs for one input dim on one device."""

    def __init__(self, cfg: TrainConfig, input_dim: int, device: str | torch.device | None = None):
        self.cfg = cfg
        self.input_dim = input_dim
        self.device = resolve_device(device)
        set_strict_f32()
        self.model = self._module().eval()  # runs snapshots through functional_call

    def _module(self) -> Mlp:
        with self.device:  # made on the device: no host init and copy of fc1
            return Mlp(self.input_dim, self.cfg.hidden_features, drop_rate=self.cfg.drop_rate,
                       use_bn=self.cfg.use_bn)

    def to_device(self, x) -> torch.Tensor:
        """A numpy array or a tensor -> an f32 tensor on the trainer's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    # ------------------------------------------------------------ train
    def init_state(self, gen: torch.Generator) -> dict[str, torch.Tensor]:
        """A fresh head with flax's init, drawn from ``gen`` (the fold's)."""
        return state_of(flax_init_(self._module(), gen))

    def train_model(self, state: dict) -> Mlp:
        """A trainable head holding a copy of ``state``."""
        model = self._module()
        model.load_state_dict(state, strict=False)
        return model

    def step(self, model: Mlp, opt: torch.optim.Optimizer, xb, yb, gen) -> torch.Tensor:
        """One optimiser step on one batch -> its loss, on the device."""
        out = model.forward_train(xb, gen)
        loss = mae_and_rank_loss(out, yb, self.cfg.l1_w, self.cfg.rank_w)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    def epoch_steps(self, model, opt, x_dev, y_dev, perm: np.ndarray, gen) -> torch.Tensor:
        """Every batch of one epoch in ``perm`` order -> the summed loss x
        batch size, float64 on the device.  Never synchronises."""
        bs = self.cfg.batch_size
        perm_dev = upload(torch.from_numpy(np.asarray(perm, dtype=np.int64)), self.device)
        x_perm = x_dev.index_select(0, perm_dev)
        y_perm = y_dev.index_select(0, perm_dev)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, len(perm), bs):
            xb, yb = x_perm[i : i + bs], y_perm[i : i + bs]
            total += self.step(model, opt, xb, yb, gen).double() * xb.shape[0]
        return total

    def train_epoch(self, model, opt, x_dev, y_dev, perm: np.ndarray, gen) -> float:
        """``epoch_steps`` and the epoch's one fetch: the summed loss."""
        return self.epoch_steps(model, opt, x_dev, y_dev, perm, gen).item()

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def _eval(self, snapshot: ModelSnapshot, x, y, batch_size: int):
        state = {k: v.to(self.device) for k, v in snapshot.state.items()}
        x = self.to_device(x)
        preds = []
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, len(x), batch_size):
            out = functional_call(self.model, state, (x[i : i + batch_size],)).reshape(-1)
            preds.append(out)
            if y is not None:
                loss = mae_and_rank_loss(out, y[i : i + batch_size], self.cfg.l1_w, self.cfg.rank_w)
                total += loss.double() * out.shape[0]
        return torch.cat(preds), total

    def predict(self, snapshot: ModelSnapshot, x, batch_size: int = 4096) -> np.ndarray:
        return self._eval(snapshot, x, None, batch_size)[0].cpu().numpy()

    def evaluate_loss(self, snapshot: ModelSnapshot, x, y, batch_size: int) -> tuple[float, np.ndarray]:
        """Size-weighted mean of the batch losses, and the predictions."""
        preds, total = self._eval(snapshot, x, self.to_device(y), batch_size)
        return total.item() / len(preds), preds.cpu().numpy()

    @torch.no_grad()
    def update_bn(self, snapshot: ModelSnapshot, x, rng: np.random.Generator) -> ModelSnapshot:
        """torch ``swa_utils.update_bn``'s result without its train-mode BN:
        the cumulative average of each batch's mean and unbiased variance of
        the pre-BN activations over ``rng.permutation``; the ragged last
        batch keeps its own unbiased variance."""
        if not self.cfg.use_bn:
            return snapshot
        idx = rng.permutation(len(x))
        state = {k: v.to(self.device) for k, v in snapshot.state.items()}
        x = self.to_device(x)
        idx_dev = upload(torch.from_numpy(idx), self.device)
        mean_acc = var_acc = None
        for k, i in enumerate(range(0, len(x), self.cfg.batch_size), start=1):
            xb = x.index_select(0, idx_dev[i : i + self.cfg.batch_size])
            bmean, bvar = bn_batch_stats(xb, state["fc1.weight"], state["fc1.bias"])
            if mean_acc is None:
                mean_acc, var_acc = bmean, bvar
            else:
                mean_acc = mean_acc + (bmean - mean_acc) / k
                var_acc = var_acc + (bvar - var_acc) / k
        state["bn1.running_mean"], state["bn1.running_var"] = mean_acc, var_acc
        return ModelSnapshot(state)


def _is_better(criteria: str, best: float, cur: float) -> bool:
    return cur < best if criteria == "byrmse" else cur > best


def train_and_evaluate(
    x_train: np.ndarray,
    y_train: np.ndarray,
    cfg: TrainConfig,
    trainer: MlpTrainer | None = None,
    log: Callable[[str], None] = lambda s: None,
    device: str | torch.device | None = None,
):
    """K-fold (or single-split) training -> (best ModelSnapshot, trainer,
    per-fold train losses, per-fold val losses)."""
    trainer = trainer or MlpTrainer(cfg, x_train.shape[1], device)
    dev = trainer.device
    rng = np.random.default_rng(cfg.seed)
    y_train = np.asarray(y_train)

    if cfg.kfold:
        folds = kfold_split(len(x_train), cfg.n_splits, 42)
    else:
        folds = [train_test_split(np.arange(len(x_train)), 0.2, 42)]

    best_snapshot: ModelSnapshot | None = None
    best_metric = float("inf") if cfg.select_criteria == "byrmse" else float("-inf")
    all_train_losses: list[list[float]] = []
    all_val_losses: list[list[float]] = []
    swa_start = int(cfg.epochs * cfg.swa_start_frac) if cfg.use_swa else cfg.epochs
    epoch_lrs = reference_lr_sequence(cfg)

    # the matrix goes to the device once; folds are device-side gathers
    x_all = trainer.to_device(x_train)
    y_all = trainer.to_device(y_train)

    for fold, (tr_idx, val_idx) in enumerate(folds):
        y_val = y_train[val_idx]
        tr_dev, val_dev = (upload(torch.from_numpy(i), dev) for i in (tr_idx, val_idx))
        x_tr, y_tr = x_all.index_select(0, tr_dev), y_all.index_select(0, tr_dev)
        x_val, y_val_dev = x_all.index_select(0, val_dev), y_all.index_select(0, val_dev)

        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(0, 2**31 - 1)))
        init = trainer.init_state(gen)
        init_stats = {k: v.clone() for k, v in init.items() if ".running_" in k}  # SWA eval buffers
        model = trainer.train_model(init)
        opt = make_optimizer(cfg, model.parameters())

        swa: dict[str, torch.Tensor] | None = None
        swa_n = 0
        train_losses: list[float] = []
        val_losses: list[float] = []
        best_val_loss = float("inf")
        epochs_no_improve = 0
        early_stop_active = False

        for epoch in range(cfg.epochs):
            set_lr(opt, epoch_lrs[epoch])
            perm = rng.permutation(len(tr_idx))
            train_losses.append(trainer.train_epoch(model, opt, x_tr, y_tr, perm, gen) / len(tr_idx))

            if cfg.use_swa and epoch >= swa_start:
                swa, swa_n = swa_update(swa, swa_n, model)
                early_stop_active = True

            # evaluate the current model (the SWA model once engaged)
            if swa is not None:
                current = ModelSnapshot({**swa, **init_stats})
            else:
                current = ModelSnapshot(state_of(model))
            val_loss, y_val_pred = trainer.evaluate_loss(current, x_val, y_val_dev, cfg.batch_size)
            val_losses.append(val_loss)

            try:
                _, _, rmse_val, _, krcc_val = compute_correlation_metrics(y_val, y_val_pred)
            except Exception:
                rmse_val, krcc_val = float("inf"), float("-inf")
            cur_metric = rmse_val if cfg.select_criteria == "byrmse" else krcc_val
            if _is_better(cfg.select_criteria, best_metric, cur_metric):
                best_metric = cur_metric
                best_snapshot = ModelSnapshot(_clone(current.state))
                log(f"fold {fold + 1} epoch {epoch + 1}: new best "
                    f"{cfg.select_criteria}={cur_metric:.4f} (val RMSE {rmse_val:.4f})")

            # early stopping, only once SWA is on; snapshots the RAW model
            if early_stop_active:
                if val_loss < best_val_loss:
                    best_val_loss = val_loss
                    best_snapshot = ModelSnapshot(_clone(state_of(model)))
                    epochs_no_improve = 0
                else:
                    epochs_no_improve += 1
                    if epochs_no_improve >= cfg.patience:
                        log(f"fold {fold + 1}: early stop after {epoch + 1} epochs")
                        break

        # degenerate folds (every metric fit failed): the final raw model
        if best_snapshot is None:
            best_snapshot = ModelSnapshot(_clone(state_of(model)))

        # SWA BN recalibration on this fold's train split
        if cfg.use_swa:
            best_snapshot = trainer.update_bn(best_snapshot, x_tr, rng)

        all_train_losses.append(train_losses)
        all_val_losses.append(val_losses)
        pad = lambda ls: [x + [x[-1]] * (max(map(len, ls)) - len(x)) for x in ls]  # noqa: E731
        all_train_losses = pad(all_train_losses)
        all_val_losses = pad(all_val_losses)

    return best_snapshot, trainer, all_train_losses, all_val_losses


@dataclasses.dataclass
class RepeatResult:
    srcc: float
    krcc: float
    plcc: float
    rmse: float
    test_vids: list
    y_test: np.ndarray
    y_pred: np.ndarray
    snapshot: ModelSnapshot


def select_median_model(results: list[RepeatResult], criteria: str) -> tuple[RepeatResult, float, np.ndarray]:
    """The median-by-RMSE/KRCC repeat."""
    vals = np.nan_to_num(np.array([r.rmse if criteria == "byrmse" else r.krcc for r in results]))
    median = np.median(vals)
    idx = np.where(vals == median)[0]
    if len(idx) == 0:  # even count: the median is not attained; take the closest
        idx = [int(np.argmin(np.abs(vals - median)))]
    return results[int(idx[0])], float(median), vals

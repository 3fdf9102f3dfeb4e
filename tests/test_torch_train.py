"""The port's training modules against the JAX package's, on the same numpy
inputs: sklearn's split indices, the MAE + rank loss and its gradient, the
learning-rate sequence, the train-mode forward, ``train_epoch`` for each
optimiser, ``update_bn``, ``train_and_evaluate``, the scaler's fit, the
metrics and the snapshot format.

Small size: d = 48, hidden 32, n <= 200, on the CPU.  Where the JAX package
draws an init, it is carried into the port (``models.porters.mlp_from_jax``),
and dropout is 0, so the runs are comparable step for step.  Tolerances:
parameters, BN buffers and losses after training rtol 2e-3, atol 2e-4 (as
``tests/test_train_dynamics.py``); single forward passes and losses rtol
1e-5; the scaler and the metrics bit-equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold
from sklearn.model_selection import train_test_split as sk_train_test_split

import relaxtpu.model.train as jtrain
from relaxtpu.model.losses import mae_and_rank_loss as jax_loss
from relaxtpu.model.metrics import compute_correlation_metrics as jax_metrics
from relaxtpu.model.mlp import Mlp as JaxMlp
from relaxtpu.model.scalers import FeatureScaler as JaxScaler
from relaxtpu.utils.checkpoint import load_snapshot as jax_load_snapshot
from relaxtpu_torch.data.splits import kfold_split, train_test_split
from relaxtpu_torch.model import train as ttrain
from relaxtpu_torch.model.losses import mae_and_rank_loss
from relaxtpu_torch.model.metrics import compute_correlation_metrics
from relaxtpu_torch.model.mlp import Mlp, _dropout, flax_init_
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.models.porters import mlp_from_jax
from relaxtpu_torch.utils.checkpoint import load_snapshot, save_snapshot

D, HID = 48, 32
TRAIN_TOL = dict(rtol=2e-3, atol=2e-4)


def data(n: int, seed: int = 0):
    """Features in [0, 1] (as after the reference's min-max) and a MOS on
    1-100 that depends on a few of them."""
    r = np.random.default_rng(seed)
    x = r.uniform(0, 1, (n, D)).astype(np.float32)
    y = 20 + 60 * (0.6 * x[:, 0] + 0.4 * x[:, 1] ** 2) + r.normal(0, 2, n)
    return x, y


def jax_init(cfg, seed: int) -> dict:
    return jtrain.MlpTrainer(cfg, D).init_variables(jax.random.PRNGKey(seed))


def assert_state_close(state: dict, variables: dict, skip=(), **tol):
    """Port state dict against JAX {'params', 'batch_stats'}."""
    want = mlp_from_jax(jax.device_get(variables))
    assert set(want) <= set(state), (set(want), set(state))
    for k, v in want.items():
        if k in skip:
            continue
        np.testing.assert_allclose(state[k].detach().cpu().numpy(), v.numpy(), err_msg=k, **tol)


# ---------------------------------------------------------------- splits
@pytest.mark.parametrize("n", [5, 17, 150, 960, 1200])
def test_train_test_split_equals_sklearn(n):
    a = np.arange(n)
    for i in range(1, 22):
        rs = math.ceil(8.8 * i)
        got_tr, got_te = train_test_split(a, test_size=0.2, random_state=rs)
        want_tr, want_te = sk_train_test_split(a, test_size=0.2, random_state=rs)
        np.testing.assert_array_equal(got_tr, want_tr)
        np.testing.assert_array_equal(got_te, want_te)
    vids = np.array([f"v{i}" for i in range(n)], dtype=object)
    np.testing.assert_array_equal(train_test_split(vids, 0.2, 9)[1], sk_train_test_split(vids, test_size=0.2,
                                                                                         random_state=9)[1])


@pytest.mark.parametrize("n", [5, 17, 150, 960, 1200])
def test_kfold_equals_sklearn(n):
    if n < 10:
        with pytest.raises(ValueError):
            list(KFold(n_splits=10, shuffle=True, random_state=42).split(np.arange(n)))
        with pytest.raises(ValueError):
            kfold_split(n, 10, 42)
        return
    want = list(KFold(n_splits=10, shuffle=True, random_state=42).split(np.arange(n)))
    got = kfold_split(n, 10, 42)
    assert len(got) == len(want) == 10
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


# ------------------------------------------------------------------ loss
LOSS_CASES = {
    "n7": (7, None, False),
    "n7_mask": (7, [1, 1, 0, 1, 0, 1, 1], False),
    "n1": (1, None, False),
    "n1_mask": (1, [1], False),
    "n7_margin": (7, None, True),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_gradient_equal_jax(case):
    n, mask, use_margin = LOSS_CASES[case]
    r = np.random.default_rng(3)
    pred = r.normal(50, 10, n).astype(np.float32)
    true = r.normal(50, 10, n).astype(np.float32)
    if n > 2:
        true[2] = true[0]  # a tie: sign(0) = 0
    kw = dict(l1_w=0.6, rank_w=1.0, margin=2.0, use_margin=use_margin)
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    want, want_grad = jax.value_and_grad(
        lambda p: jax_loss(p, jnp.asarray(true), mask=jmask, **kw))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    tmask = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    got = mae_and_rank_loss(p, torch.tensor(true), mask=tmask, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


# -------------------------------------------------------------- schedule
@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("swa", [True, False])
def test_lr_sequence_equals_jax(opt, swa):
    for epochs, frac in ((20, 0.7), (12, 0.75), (30, 0.5)):
        kw = dict(optimizer_type=opt, use_swa=swa, epochs=epochs, swa_start_frac=frac, initial_lr=0.1)
        assert ttrain.reference_lr_sequence(ttrain.TrainConfig(**kw)) == \
            jtrain.reference_lr_sequence(jtrain.TrainConfig(**kw))


# ------------------------------------------------------------ train mode
@pytest.mark.parametrize("n", [1, 33])
def test_train_forward_equals_jax(n):
    """BN in train mode (batch stats, running stats updated with the
    unbiased variance; a one-row batch runs), dropout 0."""
    x, _ = data(n, seed=n)
    jm = JaxMlp(hidden_features=HID, drop_rate=0.0, use_bn=True)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, D)), train=False)
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(lambda a: a + 0.5, variables["batch_stats"])}
    want, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    m = Mlp(D, HID, drop_rate=0.0)
    m.load_state_dict(mlp_from_jax(variables), strict=False)
    got = m.forward_train(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_state_close(ttrain.state_of(m), {"params": variables["params"], "batch_stats": mut["batch_stats"]},
                       rtol=1e-5, atol=1e-6)


def test_dropout_and_init_follow_flax():
    """Dropout keeps 1 - rate of the values, scaled by 1 / (1 - rate), from
    the given generator; the init is LeCun normal truncated at 2 sigma."""
    x = torch.ones(20000)
    a = _dropout(x, 0.25, torch.Generator().manual_seed(5))
    b = _dropout(x, 0.25, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(a.unique(), torch.tensor([0.0, 1 / 0.75]))
    assert abs((a > 0).float().mean().item() - 0.75) < 0.02
    assert _dropout(x, 0.0, None) is x
    m = flax_init_(Mlp(4000, 256), torch.Generator().manual_seed(0))
    w = m.fc1.weight.detach()
    sigma = math.sqrt(1 / 4000)
    assert abs(w.std().item() - sigma) / sigma < 0.01
    assert w.abs().max().item() <= 2 * sigma / 0.87962566103423978 + 1e-7
    assert not m.fc1.bias.any() and torch.equal(m.bn1.running_var, torch.ones(256))


# ------------------------------------------------------------ train_epoch
def _jax_epochs(cfg, variables, x, y, perms):
    trainer = jtrain.MlpTrainer(cfg, D)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = trainer.tx.init(params)
    key = jax.random.PRNGKey(0)
    losses = []
    for e, lr in enumerate(jtrain.reference_lr_sequence(cfg)):
        opt_state.hyperparams["lr"] = jnp.asarray(lr, jnp.float32)
        params, stats, opt_state, tot, key = trainer.train_epoch(
            params, stats, opt_state, jnp.asarray(x), jnp.asarray(y, jnp.float32), perms[e], key)
        losses.append(tot)
    return {"params": params, "batch_stats": stats}, losses


def _port_epochs(cfg, variables, x, y, perms):
    trainer = ttrain.MlpTrainer(cfg, D, "cpu")
    model = trainer.train_model(mlp_from_jax(variables))
    opt = ttrain.make_optimizer(cfg, model.parameters())
    x_dev, y_dev = trainer.to_device(x), trainer.to_device(y)
    losses = []
    for e, lr in enumerate(ttrain.reference_lr_sequence(cfg)):
        ttrain.set_lr(opt, lr)
        losses.append(trainer.train_epoch(model, opt, x_dev, y_dev, perms[e], torch.Generator()))
    return ttrain.state_of(model), losses


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
def test_train_epoch_equals_jax(opt, bn):
    """4 epochs from the carried init with given permutations: 49 rows in
    batches of 16, so the last batch of each epoch has one row.

    With BN, fc1's bias does not reach the loss (the batch mean removes it):
    its gradient is 0 up to rounding.  SGD leaves it in place, but Adam and
    AdamW divide that rounding noise by its own size, so the bias (and
    bn1's running mean, which carries it) walks by about lr a step in a
    direction that the summation order decides, in the JAX package and in
    the reference alike.  For those two the test holds every other
    parameter and buffer to the tolerance and checks that the bias's
    gradient is rounding noise."""
    cfg_kw = dict(optimizer_type=opt, use_bn=bn, epochs=4, batch_size=16, hidden_features=HID,
                  drop_rate=0.0, initial_lr=0.02, weight_decay=0.005, use_swa=True, swa_start_frac=0.5)
    x, y = data(49, seed=2)
    r = np.random.default_rng(7)
    perms = [r.permutation(len(x)) for _ in range(4)]
    variables = jax_init(jtrain.TrainConfig(**cfg_kw), seed=3)
    want, want_losses = _jax_epochs(jtrain.TrainConfig(**cfg_kw), variables, x, y, perms)
    got, got_losses = _port_epochs(ttrain.TrainConfig(**cfg_kw), variables, x, y, perms)
    np.testing.assert_allclose(got_losses, want_losses, **TRAIN_TOL)
    unobservable = {"fc1.bias", "bn1.running_mean"} if bn and opt != "sgd" else set()
    assert_state_close(got, want, skip=unobservable, **TRAIN_TOL)
    if unobservable:
        model = Mlp(D, HID, drop_rate=0.0)
        model.load_state_dict(got, strict=False)
        mae_and_rank_loss(model.forward_train(torch.from_numpy(x)), torch.from_numpy(y).float()).backward()
        assert model.fc1.bias.grad.abs().max() < 1e-5 * model.fc1.weight.grad.abs().max()


def test_update_bn_equals_jax():
    x, _ = data(70, seed=4)
    cfg_kw = dict(batch_size=16, hidden_features=HID, drop_rate=0.0)
    variables = jax_init(jtrain.TrainConfig(**cfg_kw), seed=5)
    want = jtrain.MlpTrainer(jtrain.TrainConfig(**cfg_kw), D).update_bn(
        jtrain.ModelSnapshot(variables["params"], variables["batch_stats"]), x, np.random.default_rng(11))
    got = ttrain.MlpTrainer(ttrain.TrainConfig(**cfg_kw), D, "cpu").update_bn(
        ttrain.ModelSnapshot(mlp_from_jax(variables)), x, np.random.default_rng(11))
    assert_state_close(got.state, {"params": want.params, "batch_stats": want.batch_stats},
                       rtol=1e-5, atol=1e-6)


# ----------------------------------------------------- train_and_evaluate
def carry_jax_inits(monkeypatch):
    """Record each fold's init in the JAX package and replay it through the
    port's init seam, in order."""
    inits = []
    jax_init_variables = jtrain.MlpTrainer.init_variables

    def record(self, key):
        v = jax_init_variables(self, key)
        inits.append(jax.device_get(v))
        return v

    def replay(self, gen):
        return {k: v.to(self.device) for k, v in mlp_from_jax(inits.pop(0)).items()}

    monkeypatch.setattr(jtrain.MlpTrainer, "init_variables", record)
    monkeypatch.setattr(ttrain.MlpTrainer, "init_state", replay)
    return inits


@pytest.mark.parametrize("criteria", ["byrmse", "bykrcc"])
def test_train_and_evaluate_equals_jax(monkeypatch, criteria):
    """3 folds, 6 epochs, SWA from epoch 4 and early stopping (patience 1):
    each fold's train and validation losses and the selected snapshot."""
    carry_jax_inits(monkeypatch)
    cfg_kw = dict(n_splits=3, epochs=6, batch_size=16, hidden_features=HID, drop_rate=0.0,
                  initial_lr=0.05, patience=1, select_criteria=criteria, seed=4)
    x, y = data(120, seed=6)
    snap, _, tr, val = jtrain.train_and_evaluate(x, y, jtrain.TrainConfig(**cfg_kw))
    got, _, gtr, gval = ttrain.train_and_evaluate(x, y, ttrain.TrainConfig(**cfg_kw), device="cpu")
    np.testing.assert_allclose(gtr, tr, **TRAIN_TOL)
    np.testing.assert_allclose(gval, val, **TRAIN_TOL)
    assert_state_close(got.state, {"params": snap.params, "batch_stats": snap.batch_stats}, **TRAIN_TOL)


# ------------------------------------------------- scaler, metrics, snapshot
def test_scaler_fit_bit_equal_to_jax():
    r = np.random.default_rng(8)
    x = r.normal(0, 3, (60, D))
    x[1, 2], x[4, 7], x[9, 9] = np.nan, np.inf, -np.inf
    x[:, 5] = 1.5  # a zero range
    want, got = JaxScaler.fit(x), FeatureScaler.fit(x)
    for k in ("fill", "scale", "offset"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.fit_transform_like_reference(x), want.fit_transform_like_reference(x))


def test_correlation_metrics_equal_jax():
    r = np.random.default_rng(9)
    y = r.uniform(1, 5, 80)
    p = y + r.normal(0, 0.4, 80)
    got, want = compute_correlation_metrics(y, p), jax_metrics(y, p)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_snapshot_round_trip_through_jax(tmp_path):
    """A head trained by the port, saved by the port, loaded by relaxtpu,
    predicts as the port does; loaded back by the port, it is unchanged."""
    x, y = data(80, seed=10)
    cfg_kw = dict(n_splits=2, epochs=3, batch_size=16, hidden_features=HID)
    snap, trainer, _, _ = ttrain.train_and_evaluate(x, y, ttrain.TrainConfig(**cfg_kw), device="cpu")
    path = str(tmp_path / "head.npz")
    save_snapshot(path, snap)
    jsnap = jax_load_snapshot(path)
    want = jtrain.MlpTrainer(jtrain.TrainConfig(**cfg_kw), D).predict(jsnap, x)
    np.testing.assert_allclose(trainer.predict(snap, x), want, rtol=0, atol=1e-5)
    back = load_snapshot(path)
    for k, v in snap.state.items():
        assert torch.equal(back.state[k], v), k

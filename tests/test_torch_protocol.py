"""The port's split functions, evaluation protocols and training CLIs
against the JAX package's, on the same numpy inputs and CSV files.

Small size (d = 48, hidden 32, n <= 120, CPU).  The JAX package's inits
are carried into the port through its init seam and dropout is 0, so the
protocols' metrics are held to 1e-3; splits and metadata are equal.
"""

import json
import os

import jax
import numpy as np
import pandas as pd
import pytest

import relaxtpu.model.protocol as jprotocol
import relaxtpu.model.train as jtrain
from relaxtpu.data import splits as jsplits
from relaxtpu.data.greyscale import load_grey_indices as jax_grey
from relaxtpu.utils.checkpoint import load_snapshot as jax_load_snapshot
from relaxtpu_torch.cli.__main__ import main
from relaxtpu_torch.data import splits as tsplits
from relaxtpu_torch.data.greyscale import load_grey_indices
from relaxtpu_torch.io.datasets import get_dataset, load_metadata, read_metadata_csv
from relaxtpu_torch.model import protocol as tprotocol
from relaxtpu_torch.model import train as ttrain
from relaxtpu_torch.models.porters import mlp_from_jax
from test_torch_train import D, HID, carry_jax_inits, data

METRICS = ("srcc", "krcc", "plcc", "rmse")


def write_meta(path, vids, mos) -> str:
    pd.DataFrame({"vid": vids, "mos": mos, "framerate": 24.0}).to_csv(path, index=False)
    return str(path)


def write_grey(path, rows) -> str:
    pd.DataFrame({"Index": [i for i, _ in rows], "vid": [v for _, v in rows],
                  "Is Greyscale": True}).to_csv(path, index=False)
    return str(path)


@pytest.fixture
def csvs(tmp_path):
    """Two metadata CSVs (numeric and string vids, one vid twice) and a
    greyscale report for each."""
    r = np.random.default_rng(0)
    vids_a = [str(1000 + i) for i in range(40)]
    vids_a[7] = vids_a[3]
    vids_b = [f"b_{i}" for i in range(30)]
    return {
        "a": write_meta(tmp_path / "a.csv", vids_a, r.uniform(1, 5, 40)),
        "b": write_meta(tmp_path / "b.csv", vids_b, r.uniform(1, 100, 30)),
        "grey_a": write_grey(tmp_path / "ga.csv", [(2, vids_a[2]), (11, vids_a[11])]),
        "grey_b": write_grey(tmp_path / "gb.csv", [(5, vids_b[5])]),
        "xa": r.normal(size=(40, 6)), "xb": r.normal(size=(30, 6)),
    }


def test_metadata_and_grey_indices_equal_pandas(csvs, tmp_path):
    meta = read_metadata_csv(csvs["a"])
    df = pd.read_csv(csvs["a"], float_precision="round_trip")  # the default parser can be 1 ulp off
    assert list(meta["vid"]) == [str(v) for v in df["vid"]]
    np.testing.assert_array_equal(meta["mos"], df["mos"].to_numpy(float))
    for g in ("grey_a", "grey_b"):
        assert load_grey_indices(csvs[g]) == jax_grey(csvs[g])
    assert load_grey_indices(str(tmp_path / "absent.csv")) == jax_grey(str(tmp_path / "absent.csv")) == []
    os.rename(csvs["b"], tmp_path / "LIVE_VQC_metadata.csv")
    assert list(load_metadata(get_dataset("live_vqc"), str(tmp_path))["vid"])[:2] == ["b_0", "b_1"]


def test_split_functions_equal_jax(csvs):
    ga, gb = load_grey_indices(csvs["grey_a"]), load_grey_indices(csvs["grey_b"])
    ma, mb = read_metadata_csv(csvs["a"]), read_metadata_csv(csvs["b"])
    da, db = (pd.read_csv(csvs[k], float_precision="round_trip") for k in "ab")
    for rs in (9, 18, 185):
        got = tsplits.split_other(ma, csvs["xa"], 0.2, rs, grey_indices=ga)
        want = jsplits.split_other(da, csvs["xa"], 0.2, rs, grey_indices=ga)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert [str(v) for v in got[4]] == [str(v) for v in want[4]]
    for fn, kw in ((tsplits.split_lsvq, {}),
                   (tsplits.split_cross_dataset, dict(train_name="konvid_1k", test_name="live_vqc"))):
        got = fn(ma, mb, csvs["xa"], csvs["xb"], grey_train=ga, grey_test=gb, **kw)
        want = getattr(jsplits, fn.__name__)(da, db, csvs["xa"], csvs["xb"], grey_train=ga, grey_test=gb, **kw)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert list(got[4]) == list(want[4])


def assert_results_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in METRICS:
            np.testing.assert_allclose(getattr(g, k), getattr(w, k), atol=1e-3, err_msg=k)


def cfg_kw(**kw):
    return dict(n_repeats=2, n_splits=3, epochs=5, batch_size=16, hidden_features=HID,
                drop_rate=0.0, initial_lr=0.05, **kw)


def test_repeated_holdout_equals_jax(monkeypatch, tmp_path):
    carry_jax_inits(monkeypatch)
    x, y = data(100, seed=12)
    x[4, 3], x[9, 0] = np.nan, np.inf
    vids = [f"v{i}" for i in range(100)]
    df = pd.DataFrame({"vid": vids, "mos": y})
    meta = {"vid": np.array(vids, dtype=object), "mos": y}
    quiet = lambda s: None  # noqa: E731
    _, want_val, want = jprotocol.run_repeated_holdout(df, x, jtrain.TrainConfig(**cfg_kw()),
                                                       grey_indices=[5, 50], progress=quiet)
    _, got_val, got = tprotocol.run_repeated_holdout(meta, x, ttrain.TrainConfig(**cfg_kw()), grey_indices=[5, 50],
                                                     progress=quiet, resume_dir=str(tmp_path), device="cpu")
    assert_results_close(got, want)
    np.testing.assert_allclose(got_val, want_val, atol=1e-3)
    assert [r.test_vids for r in got] == [list(r.test_vids) for r in want]
    lines = []  # a rerun resumes both repeats from the kept snapshots
    _, _, again = tprotocol.run_repeated_holdout(meta, x, ttrain.TrainConfig(**cfg_kw()), progress=lines.append,
                                                 resume_dir=str(tmp_path), device="cpu")
    assert sum("resumed" in ln for ln in lines) == 2
    assert_results_close(again, got)


def test_fixed_split_equals_jax(monkeypatch):
    """The LSVQ variant: one 80/20 validation split, no BN, bykrcc."""
    carry_jax_inits(monkeypatch)
    x, y = data(120, seed=13)
    kw = cfg_kw(use_bn=False, kfold=False, select_criteria="bykrcc")
    want, _ = jprotocol.run_fixed_split(x[:90], y[:90], x[90:], y[90:], jtrain.TrainConfig(**kw),
                                        progress=lambda s: None)
    got, _ = tprotocol.run_fixed_split(x[:90], y[:90], x[90:], y[90:], ttrain.TrainConfig(**kw),
                                       progress=lambda s: None, device="cpu")
    assert_results_close([got], [want])
    np.testing.assert_allclose(got.y_pred, want.y_pred, rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def base():
    """A head trained by the JAX package (BN on), carried into the port."""
    x, y = data(100, seed=14)
    cfg = jtrain.TrainConfig(**cfg_kw(kfold=False))
    snap, _, _, _ = jtrain.train_and_evaluate(x, y, cfg)
    variables = jax.device_get({"params": snap.params, "batch_stats": snap.batch_stats})
    return snap, ttrain.ModelSnapshot(mlp_from_jax(variables))


def test_fine_tune_and_zero_shot_equal_jax(base):
    x, y = data(90, seed=15)
    y5 = 1 + (y - y.min()) / np.ptp(y) * 4
    ft = jprotocol.FineTuneConfig(n_repeats=2, epochs=4, batch_size=16)
    jtr = jtrain.MlpTrainer(jtrain.TrainConfig(hidden_features=HID, drop_rate=0.0), D)
    ttr = ttrain.MlpTrainer(ttrain.TrainConfig(hidden_features=HID, drop_rate=0.0), D, "cpu")
    tft = tprotocol.FineTuneConfig(n_repeats=2, epochs=4, batch_size=16)
    quiet = lambda s: None  # noqa: E731
    for jfn, tfn in ((jprotocol.fine_tune, tprotocol.fine_tune),
                     (jprotocol.zero_shot_eval, tprotocol.zero_shot_eval)):
        _, want = jfn(base[0], jtr, x, y5, ft, mos_is_1_5=True, progress=quiet)
        _, got = tfn(base[1], ttr, x, y5, tft, mos_is_1_5=True, progress=quiet)
        assert_results_close(got, want)


# ---------------------------------------------------------------------- CLI
JAX_CLI_KEYS = {  # the JSON lines of relaxtpu/cli/__main__.py:596-704,870
    "train": {"median_srcc", "median_krcc", "median_plcc", "median_rmse", "model"},
    "train-lsvq": {"srcc", "krcc", "plcc", "rmse", "model"},
    "finetune": {"median_srcc", "median_rmse", "model"},
    "finetune --zero-shot": {"median_srcc", "median_rmse", "zero_shot"},
    "train-cross": {"srcc", "plcc", "rmse"},
}


def test_training_clis_on_cpu(tmp_path, capsys):
    x, y = data(80, seed=16)
    y5 = 1 + (y - y.min()) / np.ptp(y) * 4
    feats = str(tmp_path / "f.npy")
    np.save(feats, x)
    meta = write_meta(tmp_path / "m.csv", [f"v{i}" for i in range(80)], y5)
    p = lambda name: str(tmp_path / name)  # noqa: E731
    small = ["--epochs", "3", "--device", "cpu"]
    runs = {
        "train": ["train", "--metadata-csv", meta, "--features", feats, "--output", p("t.npz"),
                  "--n-repeats", "2", "--n-splits", "3", "--batch-size", "16",
                  "--artifacts-dir", p("art"), *small],
        "train-lsvq": ["train-lsvq", "--train-metadata", meta, "--test-metadata", meta,
                       "--train-features", feats, "--test-features", feats, "--output", p("l.npz"),
                       "--batch-size", "16", *small],
        "finetune": ["finetune", "--dataset", "konvid_1k", "--metadata-csv", meta, "--features", feats,
                     "--base-model", p("t.npz"), "--output", p("ft.npz"), "--n-repeats", "2", *small],
        "finetune --zero-shot": ["finetune", "--dataset", "konvid_1k", "--metadata-csv", meta,
                                 "--features", feats, "--base-model", p("l.npz"), "--no-bn",
                                 "--zero-shot", "--n-repeats", "2", *small],
        "train-cross": ["train-cross", "--train-dataset", "konvid_1k", "--test-dataset", "konvid_1k",
                        "--train-metadata", meta, "--test-metadata", meta, "--train-features", feats,
                        "--test-features", feats, "--output", p("c.npz"), *small],
    }
    for name, argv in runs.items():
        main(argv)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(res) == JAX_CLI_KEYS[name], name
        assert all(np.isfinite(v) for v in res.values() if isinstance(v, float)), res
    assert "config: TrainConfig" in open(p("art/train.log")).read()
    for name in ("t.npz", "l.npz", "ft.npz", "c.npz"):
        assert jax_load_snapshot(p(name)).params["fc1"]["kernel"].shape == (D, 256)

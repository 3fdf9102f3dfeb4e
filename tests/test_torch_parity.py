"""``relaxtpu_torch.parity`` and ``parity`` CLI against the JAX package's.

- ``head_parity`` on the reference-format artifacts that the JAX package's
  own test synthesises (``tests/test_parity_readiness.py``), with and
  without a greyscale report: the same report (n, ok; the differences
  within 1e-6); a perturbed expected CSV fails both.
- ``parity --check all`` through both CLIs, the features and production
  checks stubbed as the JAX package's test stubs them, the head check run:
  the same ``ran``, ``ok``, skip messages and exit codes.
- ``feature_parity(None, n_frames=2)`` on the CPU (full-width seeded
  ResNet-50 and ViT-B/16): every segment within the JAX package's bounds;
  the port's reference vector bit-equal to ``relaxtpu.oracle``'s; TF32
  turned off (a spy on ``set_strict_f32`` and the flags after the call).
- ``production_numerics(device="cpu")``: within the JAX package's bounds
  (measured on this CPU: flow mean 1.8e-7 px, p99 7.2e-7 px; bf16 cosine
  0.9999884, median relative error 5.4e-3).
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import relaxtpu.cli.__main__ as jax_cli
import relaxtpu.oracle as joracle
import relaxtpu.parity as jparity
from relaxtpu_torch import oracle as toracle
from relaxtpu_torch import parity as tparity
from relaxtpu_torch.cli import __main__ as cli
from tests.test_parity_readiness import _make_artifacts


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def head_args(art):
    return (art["features_mat"], art["metadata_csv"], art["result_mat"], art["model_pth"],
            art["imputer_pkl"], art["scaler_pkl"], art["expected_csv"])


@pytest.mark.parametrize("grey", [False, True], ids=["all_rows", "greyscale_dropped"])
def test_head_parity_equals_jax(tmp_path, grey):
    art = _make_artifacts(tmp_path, np.random.default_rng(0))
    report = None
    if grey:  # rows 0 and 3 are train videos; dropping them keeps the test split
        report = str(tmp_path / "grey.csv")
        pd.DataFrame({"Index": [0, 3], "vid": ["3000", "3003"], "Is Greyscale": True}).to_csv(report, index=False)
    want = jparity.head_parity("konvid_1k", *head_args(art), greyscale_report=report)
    got = tparity.head_parity("konvid_1k", *head_args(art), greyscale_report=report, device="cpu")
    assert (got.n, got.ok, got.tolerance) == (want.n, want.ok, want.tolerance) == (6, True, 0.05)
    assert abs(got.max_abs_diff - want.max_abs_diff) <= 1e-6
    assert abs(got.mean_abs_diff - want.mean_abs_diff) <= 1e-6
    assert set(json.loads(got.to_json())) == set(json.loads(want.to_json()))


def test_head_parity_detects_divergence(tmp_path):
    art = _make_artifacts(tmp_path, np.random.default_rng(0))
    df = pd.read_csv(art["expected_csv"])
    df["y_test_pred"] += 1.0
    df.to_csv(art["expected_csv"], index=False)
    want = jparity.head_parity("konvid_1k", *head_args(art))
    got = tparity.head_parity("konvid_1k", *head_args(art), device="cpu")
    assert not got.ok and not want.ok
    assert abs(got.max_abs_diff - want.max_abs_diff) <= 1e-6


def test_median_test_vids_flatten_matlab_cells(tmp_path):
    """Nested cells, bytes, ints and integral floats, as the JAX package reads them."""
    import scipy.io

    path = str(tmp_path / "r.mat")
    cells = np.empty(3, dtype=object)
    cells[0] = np.asarray(["a1 ", "b2"], dtype=object)
    cells[1] = np.float64(3000.0)
    cells[2] = np.asarray([7, 8.5])
    scipy.io.savemat(path, {"Test_videos_Median_model": cells})
    assert tparity._median_test_vids(path) == jparity._median_test_vids(path)


@pytest.mark.parametrize("features_ok", [True, False])
def test_parity_all_cli_equals_jax(tmp_path, monkeypatch, capsys, features_ok):
    """``--check all`` through both CLIs: features and production stubbed
    (the JAX package's production check is TPU-only), head run for real,
    demo skipped with its missing flags named."""
    for mod in (jparity, tparity):
        monkeypatch.setattr(mod, "feature_parity",
                            lambda *a, **k: {"ok": features_ok, "segments": {}, "weights": "stub"})
        monkeypatch.setattr(mod, "production_numerics", lambda *a, **k: {"skipped": "stubbed in test"})
    art = _make_artifacts(tmp_path, np.random.default_rng(0))
    argv = ["parity", "--check", "all", "--dataset", "konvid_1k",
            "--features-mat", art["features_mat"], "--metadata-csv", art["metadata_csv"],
            "--result-mat", art["result_mat"], "--expected-csv", art["expected_csv"],
            "--model", art["model_pth"], "--imputer", art["imputer_pkl"], "--scaler", art["scaler_pkl"]]
    rc_want = jax_cli.main(argv)
    want = json.loads(capsys.readouterr().out)
    rc_got = cli.main([*argv, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert (rc_got, got["ran"], got["ok"]) == (rc_want, want["ran"], want["ok"]) == (
        0 if features_ok else 1, 2, features_ok)
    for check in ("demo", "production"):
        assert got["checks"][check] == want["checks"][check]
    assert "--video" in got["checks"]["demo"]["skipped"]
    assert got["checks"]["head"]["ok"] is want["checks"]["head"]["ok"] is True


def test_parity_all_without_blobs_names_missing_flags(monkeypatch, capsys):
    for mod in (jparity, tparity):
        monkeypatch.setattr(mod, "feature_parity", lambda *a, **k: {"ok": True, "segments": {}})
        monkeypatch.setattr(mod, "production_numerics", lambda *a, **k: {"skipped": "stubbed in test"})
    rc_want = jax_cli.main(["parity", "--check", "all"])
    want = json.loads(capsys.readouterr().out)
    rc_got = cli.main(["parity", "--check", "all", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert rc_got == rc_want == 0 and got["ran"] == want["ran"] == 1
    assert got["checks"]["head"] == want["checks"]["head"]
    assert got["checks"]["demo"] == want["checks"]["demo"]


def test_feature_parity_on_cpu(monkeypatch):
    """The real check at full width on the CPU: within the JAX package's
    bounds, the reference vector equal to relaxtpu.oracle's, TF32 off."""
    calls, vecs = [], {}
    real_strict, real_ref = tparity.set_strict_f32, toracle.reference_video_feature

    def strict_spy():
        calls.append(True)
        real_strict()

    def ref_spy(frames, nxt, rn, vit):
        vecs["frames"], vecs["nxt"] = frames, nxt
        vecs["port"] = real_ref(frames, nxt, rn, vit)
        return vecs["port"]

    monkeypatch.setattr(tparity, "set_strict_f32", strict_spy)
    monkeypatch.setattr(toracle, "reference_video_feature", ref_spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    out = tparity.feature_parity(None, n_frames=2, device="cpu")
    assert calls and not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert out["ok"] is True and out["n_frames"] == 2 and out["weights"] == "seeded-random"
    assert set(out["segments"]) == {"resnet_stack", "vit_pool", "frag_resnet", "frag_vit"}
    for seg, (cos, rel) in tparity.FEATURE_TOL.items():
        assert out["segments"][seg]["cosine"] >= cos and out["segments"][seg]["mean_abs_err_over_mean_abs"] <= rel
    want = joracle.reference_video_feature(vecs["frames"], vecs["nxt"], joracle.build_torch_resnet50(seed=0),
                                           joracle.build_torch_vit(seed=1))
    np.testing.assert_array_equal(vecs["port"], want)


def test_production_numerics_on_cpu():
    out = tparity.production_numerics(device="cpu")
    assert out["device"] == "cpu" and out["ok"] is True, out
    assert out["flow_mean_err_px"] <= 5e-3 and out["flow_p99_err_px"] <= 5e-2
    assert out["bf16_cosine"] >= 0.9999 and out["bf16_median_rel"] <= 5e-2

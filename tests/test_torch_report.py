"""``utils/report``, ``data/recover``, ``utils/plots`` and the ``report`` and
``train --artifacts-dir`` CLIs against the JAX package's, on the same fake
repeat results, training logs and VSFA ``.npy`` files: values equal (a
MOS read from a CSV within an ulp: pandas' default float parser is not
correctly rounded, the port's ``float`` is), CSVs byte-equal, the same
artifact file names.
"""

import os

import numpy as np
import pandas as pd
import pytest
import scipy.io
import torch

import relaxtpu.cli.__main__ as jax_cli
import relaxtpu.data.recover as jrecover
import relaxtpu.utils.report as jreport
from relaxtpu.model.train import RepeatResult
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.data import recover as trecover
from relaxtpu_torch.io.datasets import read_metadata_csv
from relaxtpu_torch.utils import report as treport

METHODS = ("relaxvqa", "BRISQUE", "TLVQM")
DATASETS = ("konvid_1k", "cvd_2014", "live_vqc")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_results(seed: int, n: int = 5, n_test: int = 8) -> list:
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y = r.uniform(1, 5, n_test)
        srcc = float("nan") if i == 2 and seed % 2 else float(r.uniform(0.5, 0.9))
        out.append(RepeatResult(srcc, r.uniform(0.4, 0.7), r.uniform(0.5, 0.9), r.uniform(0.2, 0.5),
                                [f"v{seed}_{i}_{k}" for k in range(n_test)], y, y + r.normal(0, 0.3, n_test), None))
    return out


def frame_rows(df: pd.DataFrame) -> list:
    """A frame as the port's rows: NaN cells dropped, numbers as floats."""
    return [{k: v for k, v in row.items() if not (isinstance(v, float) and np.isnan(v))}
            for row in df.to_dict("records")]


def assert_rows_equal(rows, df):
    assert treport.table_columns(rows) == list(df.columns)
    assert rows == frame_rows(df)


def test_summary_and_tables_equal_jax():
    per_method = {m: {ds: fake_results(10 * i + j) for j, ds in enumerate(DATASETS)} for i, m in enumerate(METHODS)}
    for results in per_method["BRISQUE"].values():
        assert treport.summarize_repeats(results) == jreport.summarize_repeats(results)
    rows, df = treport.comparison_table(per_method), jreport.comparison_table(per_method)
    assert_rows_equal(rows, df)
    for base in (jreport.REFERENCE_INTRA_DATASET, jreport.REFERENCE_FINETUNED):
        assert_rows_equal(treport.against_baseline(rows, base), jreport.against_baseline(df, base))
    assert treport.REFERENCE_INTRA_DATASET == jreport.REFERENCE_INTRA_DATASET
    assert treport.REFERENCE_FINETUNED == jreport.REFERENCE_FINETUNED


LOG = """epoch 1 loss 0.5
Average training results among all repeated 80-20 holdouts:
SRCC Train: 0.9{a} (std: 0.01)
KRCC Train: 0.8{a} (std: 0.02)
Average testing results among all repeated 80-20 holdouts:
SRCC Test: 0.7{a} (std: 0.03)
KRCC Test: 0.5{a} (std: 4e-2)
PLCC Test: 0.7{b} (std: 0.05)
RMSE Test: {b}.25 (std: 0.1)
Median SRCC: 0.71{a}
"""


def write_inputs(tmp_path) -> tuple[list, list]:
    """Logs of three methods on two datasets (one log with a train block
    only) and two VSFA .npy results -> (--log specs, --vsfa-npy specs)."""
    logs = []
    for i, m in enumerate(METHODS):
        for j, ds in enumerate(DATASETS[:2]):
            path = tmp_path / f"{m}_{ds}.log"
            text = LOG.format(a=i, b=j + 1)
            if (i, j) == (2, 1):
                text = text.split("Average testing")[0]
            path.write_text(text)
            logs.append(f"{m}={ds}={path}")
    vsfa = []
    for k, ds in enumerate(DATASETS[1:]):
        d = np.empty(8, dtype=object)
        d[0], d[1], d[2] = np.arange(5.0), np.arange(5.0 + k), 0.1
        d[3:7] = [0.61 + k, 0.45, 0.66, 7.5]
        d[7] = np.arange(5 + k)
        path = str(tmp_path / f"vsfa_{ds}.npy")
        np.save(path, d, allow_pickle=True)
        vsfa.append(f"{ds}={path}")
    return logs, vsfa


def test_log_and_vsfa_parsers_equal_jax(tmp_path):
    logs, vsfa = write_inputs(tmp_path)
    for spec in logs:
        text = open(spec.split("=", 2)[2]).read()
        assert treport.parse_training_log(text) == jreport.parse_training_log(text)
    for spec in vsfa:
        path = spec.split("=", 1)[1]
        assert treport.parse_vsfa_npy(path) == jreport.parse_vsfa_npy(path)
    paths = {}
    for spec in logs:
        m, ds, path = spec.split("=", 2)
        paths.setdefault(m, {})[ds] = path
    assert_rows_equal(treport.competitor_table(paths), jreport.competitor_table(paths))


@pytest.mark.parametrize("what", ["logs", "vsfa", "logs+vsfa+baseline", "baseline"])
def test_report_cli_equals_jax(tmp_path, capsys, what):
    """The same rows printed, the CSV byte-equal to pandas'."""
    logs, vsfa = write_inputs(tmp_path)
    argv = ["report"]
    if "logs" in what:
        argv += [a for spec in logs for a in ("--log", spec)]
    if "vsfa" in what:
        argv += [a for spec in vsfa for a in ("--vsfa-npy", spec)]
    if "baseline" in what:
        argv.append("--with-baseline")
    jax_cli.main([*argv, "--output-csv", str(tmp_path / "jax.csv")])
    capsys.readouterr()
    cli.main([*argv, "--output-csv", str(tmp_path / "torch.csv")])
    printed = capsys.readouterr().out.strip().splitlines()
    assert open(tmp_path / "torch.csv", "rb").read() == open(tmp_path / "jax.csv", "rb").read()
    want = pd.read_csv(tmp_path / "jax.csv")
    assert printed[0].split() == list(want.columns)
    assert len(printed) == len(want) + 1


def test_report_cli_refuses_nothing_and_bad_specs(capsys):
    with pytest.raises(SystemExit, match="nothing to report"):
        cli.main(["report"])
    with pytest.raises(SystemExit, match="METHOD=DATASET=PATH"):
        cli.main(["report", "--log", "x.log"])


def test_recover_and_exports_equal_jax(tmp_path):
    r = np.random.default_rng(3)
    vids = [str(3000 + i) for i in range(30)]
    meta_csv = str(tmp_path / "meta.csv")
    pd.DataFrame({"vid": vids, "mos": r.uniform(1, 5, 30)}).to_csv(meta_csv, index=False)
    feats = r.normal(size=(30, 7))
    test_vids = [3004, "3010", "3029", "nope"]
    got = trecover.recover_median_split(read_metadata_csv(meta_csv), feats, test_vids)
    want = jrecover.recover_median_split(pd.read_csv(meta_csv), feats, test_vids)
    for g, w in zip(got[::2], want[::2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1::2], want[1::2]):  # pandas' CSV float parser may miss by an ulp
        np.testing.assert_allclose(g, w, rtol=1e-15, atol=0)
    assert len(got[2]) == 3

    results = fake_results(7)
    for name, mod in (("jax", jrecover), ("torch", trecover)):
        mod.export_results_mat(str(tmp_path / f"{name}.mat"), results, "byrmse", 0.31)
        mod.export_predictions_csv(str(tmp_path / f"{name}.csv"), results[1])
    assert open(tmp_path / "torch.csv", "rb").read() == open(tmp_path / "jax.csv", "rb").read()
    a, b = scipy.io.loadmat(tmp_path / "torch.mat"), scipy.io.loadmat(tmp_path / "jax.mat")
    assert {k for k in a if not k.startswith("__")} == {k for k in b if not k.startswith("__")}
    for k in ("SRCC_test", "KRCC_test", "PLCC_test", "RMSE_test", "Median_RMSE"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["Test_Videos_list"].tolist() == b["Test_Videos_list"].tolist()


def test_train_artifacts_dir_file_names_equal_jax(tmp_path, capsys):
    r = np.random.default_rng(4)
    x = r.uniform(0, 1, (40, 16)).astype(np.float32)
    y = 1 + 4 * (0.7 * x[:, 0] + 0.3 * x[:, 1]) + r.normal(0, 0.1, 40)
    feats, meta = str(tmp_path / "f.npy"), str(tmp_path / "m.csv")
    np.save(feats, x)
    pd.DataFrame({"vid": [f"v{i}" for i in range(40)], "mos": y}).to_csv(meta, index=False)
    small = ["--metadata-csv", meta, "--features", feats, "--n-repeats", "2", "--n-splits", "3",
             "--epochs", "2", "--batch-size", "16"]
    jax_cli.main(["train", *small, "--output", str(tmp_path / "j.npz"), "--artifacts-dir", str(tmp_path / "ja")])
    cli.main(["train", *small, "--output", str(tmp_path / "t.npz"), "--artifacts-dir", str(tmp_path / "ta"),
              "--device", "cpu"])
    capsys.readouterr()
    names = sorted(os.listdir(tmp_path / "ta"))
    assert names == sorted(os.listdir(tmp_path / "ja")) == [
        "losses_repeat_01.png", "losses_repeat_02.png", "median_scatter.png", "train.log"]
    for name in names[:3]:
        with open(tmp_path / "ta" / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"

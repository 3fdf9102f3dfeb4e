"""Results reporting: comparison tables across datasets and methods
(counterpart of ``relaxtpu/utils/report.py``, without pandas).

A table is a list of row dicts.  Its columns are the union of the rows'
keys in first-seen order (pandas' order for a frame built from such rows),
and the table functions sort rows by (dataset, method), stably, as pandas'
``sort_values`` does.  ``format_table`` renders one as fixed-width text and
``write_table_csv`` writes it as pandas' ``to_csv(index=False)`` would.
"""

from __future__ import annotations

import math
import re

import numpy as np

from relaxtpu_torch.io.metadata import write_csv
from relaxtpu_torch.utils.keywords import jax_keywords

METRICS = ("SRCC", "KRCC", "PLCC", "RMSE")


def summarize_repeats(results) -> dict:
    """Median and std over repeats of each metric, NaN as 0: the
    reference's headline statistic."""
    out = {}
    for k in METRICS:
        v = np.nan_to_num(np.array([getattr(r, k.lower()) for r in results]))
        out[k] = float(np.median(v))
        out[f"{k}_std"] = float(np.std(v))
    return out


def _sorted(rows: list[dict]) -> list[dict]:
    return sorted(rows, key=lambda r: (r["dataset"], r["method"]))


def comparison_table(per_method: dict[str, dict[str, list]]) -> list[dict]:
    """{method: {dataset: [RepeatResult, ...]}} -> rows of the medians."""
    rows = []
    for method, per_ds in per_method.items():
        for ds, results in per_ds.items():
            row = {"method": method, "dataset": ds}
            row.update({k: v for k, v in summarize_repeats(results).items() if not k.endswith("_std")})
            rows.append(row)
    return _sorted(rows)


@jax_keywords(df="rows")
def against_baseline(rows: list[dict], baseline: dict[str, dict[str, float]]) -> list[dict]:
    """``rows`` and the reference's published numbers side by side;
    ``baseline`` = {dataset: {metric: value}}."""
    extra = [{"method": "reference (published)", "dataset": ds, **metrics} for ds, metrics in baseline.items()]
    return _sorted(list(rows) + extra)


REFERENCE_INTRA_DATASET = {
    # log/{dataset}_relaxvqa_mlp.log "Average testing results" (BASELINE.md)
    "konvid_1k": {"SRCC": 0.8535, "KRCC": 0.6594, "PLCC": 0.8473, "RMSE": 0.3370},
    "cvd_2014": {"SRCC": 0.8643, "KRCC": 0.6960, "PLCC": 0.8895, "RMSE": 9.8185},
    "live_vqc": {"SRCC": 0.7655, "KRCC": 0.5785, "PLCC": 0.8079, "RMSE": 9.8596},
    "youtube_ugc": {"SRCC": 0.8014, "KRCC": 0.6167, "PLCC": 0.8204, "RMSE": 0.3801},
    "lsvq_train": {"SRCC": 0.8686, "KRCC": 0.6825, "PLCC": 0.8687, "RMSE": 5.1917},
}

REFERENCE_FINETUNED = {
    "konvid_1k": {"SRCC": 0.8720, "KRCC": 0.6881, "PLCC": 0.8668, "RMSE": 0.3211},
    "cvd_2014": {"SRCC": 0.8974, "KRCC": 0.7299, "PLCC": 0.9294, "RMSE": 8.1812},
    "live_vqc": {"SRCC": 0.8468, "KRCC": 0.6649, "PLCC": 0.8876, "RMSE": 7.9869},
    "youtube_ugc": {"SRCC": 0.8469, "KRCC": 0.6623, "PLCC": 0.8652, "RMSE": 0.3437},
}


def parse_training_log(text: str) -> dict:
    """A reference-format training log -> {"train": {metric: (value, std)},
    "test": {...}}, plus {"median": {metric: value}} where the log has
    "Median <metric>: <v>" lines.  The logs end with blocks such as::

        Average testing results among all repeated 80-20 holdouts:
        SRCC Test: <v> (std: <v>)
    """
    out: dict = {"train": {}, "test": {}}
    for m in re.finditer(
        r"(SRCC|KRCC|PLCC|RMSE)\s+(Train|Test):\s*([-\d.eE]+)\s*\(std:\s*([-\d.eE]+)\)",
        text,
    ):
        metric, split, val, std = m.groups()
        out[split.lower()][metric] = (float(val), float(std))
    for m in re.finditer(r"Median\s+(SRCC|KRCC|PLCC|RMSE):\s*([-\d.eE]+)", text):
        out.setdefault("median", {})[m.group(1)] = float(m.group(2))
    return out


def competitor_table(log_paths: dict[str, dict[str, str]]) -> list[dict]:
    """{method: {dataset: log_path}} -> rows of each log's test metrics
    (the competitors' SVR logs and relaxvqa's MLP logs share the format)."""
    rows = []
    for method, per_ds in log_paths.items():
        for ds, path in per_ds.items():
            with open(path) as f:
                parsed = parse_training_log(f.read())
            row = {"method": method, "dataset": ds}
            row.update({k: v[0] for k, v in parsed.get("test", {}).items()})
            rows.append(row)
    return _sorted(rows)


def parse_vsfa_npy(path: str) -> dict:
    """A VSFA result ``.npy`` (an object array: y_pred, y_test, loss, SRCC,
    KRCC, PLCC, RMSE, test_index) -> its metrics and test-set size."""
    d = np.load(path, allow_pickle=True)
    return {
        "SRCC": float(d[3]),
        "KRCC": float(d[4]),
        "PLCC": float(d[5]),
        "RMSE": float(d[6]),
        "n_test": int(len(d[1])),
    }


def table_columns(rows: list[dict]) -> list[str]:
    """The union of the rows' keys in first-seen order."""
    return list(dict.fromkeys(k for r in rows for k in r))


def _cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)


def format_table(rows: list[dict]) -> str:
    """Fixed-width text: a header line, then one line a row; a missing
    value reads NaN, floats are printed in full."""
    cols = table_columns(rows)
    cells = [cols] + [[_cell(r.get(c)) for c in cols] for r in rows]
    widths = [max(len(line[j]) for line in cells) for j in range(len(cols))]
    return "\n".join(" ".join(x.rjust(w) for x, w in zip(line, widths)) for line in cells)


def write_table_csv(path: str, rows: list[dict]) -> None:
    write_csv(path, table_columns(rows), rows)

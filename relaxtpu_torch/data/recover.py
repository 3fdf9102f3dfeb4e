"""Median-model split recovery and results export (counterpart of
``relaxtpu/data/recover.py``, without pandas).

- ``recover_median_split``: the exact train/test split of a saved median
  model, from the results file's list of test videos; ``meta`` is a
  metadata table as ``io.datasets.read_metadata_csv`` gives it.
- ``export_results_mat``: every repeat's metrics and test-video lists in the
  reference's ``.mat`` schema.
- ``export_predictions_csv``: the median model's per-video predictions,
  written as pandas' ``to_csv(index=False)`` writes them.
"""

from __future__ import annotations

import numpy as np

from relaxtpu_torch.io.metadata import write_csv
from relaxtpu_torch.model.metrics import fit_logistic
from relaxtpu_torch.utils.keywords import jax_keywords


@jax_keywords(df="meta")
def recover_median_split(meta: dict, features: np.ndarray, median_test_vids) -> tuple:
    """(x_train, y_train, x_test, y_test): the rows whose vid is in the
    recorded test list are the test set, in metadata order."""
    test_set = set(map(str, median_test_vids))
    is_test = np.array([str(v) in test_set for v in meta["vid"]], dtype=bool)
    mos = np.asarray(meta["mos"], dtype=float)
    return features[~is_test], mos[~is_test], features[is_test], mos[is_test]


def export_results_mat(path: str, results, select_criteria: str, median_value: float) -> None:
    import scipy.io

    crit = select_criteria.replace("by", "").upper()
    scipy.io.savemat(
        path,
        {
            "SRCC_test": np.asarray([r.srcc for r in results], float),
            "KRCC_test": np.asarray([r.krcc for r in results], float),
            "PLCC_test": np.asarray([r.plcc for r in results], float),
            "RMSE_test": np.asarray([r.rmse for r in results], float),
            f"Median_{crit}": median_value,
            "Test_Videos_list": np.asarray(
                [np.asarray(r.test_vids, dtype=object) for r in results], dtype=object
            ),
        },
    )


def export_predictions_csv(path: str, result) -> None:
    """MOS, y_test_pred and y_test_pred_logistic (the 4-parameter fit) per
    test video."""
    y_fit, _, _ = fit_logistic(result.y_pred, result.y_test)
    columns = ["MOS", "y_test_pred", "y_test_pred_logistic"]
    rows = [dict(zip(columns, r)) for r in zip(result.y_test, result.y_pred, y_fit)]
    write_csv(path, columns, rows)

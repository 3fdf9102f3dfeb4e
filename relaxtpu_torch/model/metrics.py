"""Evaluation metrics: 4-parameter logistic fit + PLCC/RMSE/SRCC/KRCC (own
copy of ``relaxtpu/model/metrics.py``; numpy/scipy on the host).

PLCC and RMSE are taken on the logistic-fitted predictions, SRCC and KRCC on
the raw ones, as the reference does.
"""

from __future__ import annotations

import numpy as np
import scipy.stats
from scipy.optimize import curve_fit


def logistic_func(x, b1, b2, b3, b4):
    part = 1 + np.exp(np.negative(np.divide(x - b3, np.abs(b4))))
    return b2 + np.divide(b1 - b2, part)


def fit_logistic(y_pred: np.ndarray, y_true: np.ndarray):
    beta0 = [np.max(y_true), np.min(y_true), np.mean(y_pred), 0.5]
    popt, _ = curve_fit(logistic_func, y_pred, y_true, p0=beta0, maxfev=100000000)
    return logistic_func(y_pred, *popt), beta0, popt


def compute_correlation_metrics(y_true: np.ndarray, y_pred: np.ndarray):
    """Returns (y_pred_logistic, plcc, rmse, srcc, krcc)."""
    y_true = np.asarray(y_true, dtype=float)
    y_pred = np.asarray(y_pred, dtype=float)
    y_fit, _, _ = fit_logistic(y_pred, y_true)
    plcc = scipy.stats.pearsonr(y_true, y_fit)[0]
    rmse = float(np.sqrt(np.mean((y_true - y_fit) ** 2)))
    srcc = scipy.stats.spearmanr(y_true, y_pred)[0]
    try:
        krcc = scipy.stats.kendalltau(y_true, y_pred)[0]
    except Exception:
        krcc = scipy.stats.kendalltau(y_true, y_pred, method="asymptotic")[0]
    return y_fit, float(plcc), rmse, float(srcc), float(krcc)

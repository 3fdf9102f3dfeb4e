"""Plot helpers (counterpart of ``relaxtpu/utils/plots.py``): the
logistic-fit scatter and the loss curves of a training run.  Matplotlib is
imported when a figure is drawn; where it is not installed (the card's
host) a figure is skipped with a warning, as in the JAX package."""

from __future__ import annotations

import logging

import numpy as np

from relaxtpu_torch.model.metrics import fit_logistic, logistic_func

log = logging.getLogger("relaxtpu_torch.plots")


def plot_results(y_true, y_pred_logistic, out_path: str, title: str = "", ylim=None):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        log.warning("plotting unavailable: %s", e)
        return
    plt.figure(figsize=(6, 6))
    try:  # the 4-param fit needs >=4 points; tiny/degenerate sets scatter-only
        _, _, popt = fit_logistic(np.asarray(y_pred_logistic), np.asarray(y_true))
        xs = np.linspace(
            np.min(y_pred_logistic), np.max(y_pred_logistic), len(y_pred_logistic)
        )
        plt.plot(xs, logistic_func(xs, *popt), "-", color="#c72e29", label="Fitted f(x)")
    except (RuntimeError, TypeError, ValueError) as e:
        log.warning("logistic fit unavailable for scatter plot: %s", e)
    plt.scatter(y_pred_logistic, y_true, s=12, color="steelblue", label="videos")
    if ylim:
        plt.ylim(*ylim)
        plt.xlim(*ylim)
    plt.xlabel("Predicted Score")
    plt.ylabel("MOS")
    plt.title(title, fontsize=10)
    plt.legend(loc="upper left")
    plt.savefig(out_path, dpi=150)
    plt.close()


def plot_losses(train_losses, val_losses, out_path: str, title: str = ""):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        log.warning("plotting unavailable: %s", e)
        return
    plt.figure(figsize=(8, 5))
    plt.plot(np.mean(train_losses, axis=0), label="Average Training Loss")
    plt.plot(np.mean(val_losses, axis=0), label="Average Validation Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title(title, fontsize=10)
    plt.legend()
    plt.savefig(out_path, dpi=100)
    plt.close()

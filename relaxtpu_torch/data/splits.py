"""Train/test split protocols (own copy of ``relaxtpu/data/splits.py:19-91``)
on metadata columns (``io.datasets.read_metadata_csv``).

The JAX package splits with sklearn; the port carries its own copies of the
two index rules it uses, so the splits are index-identical to sklearn's for
equal random states without sklearn:

- ``train_test_split``: ``n_test = ceil(test_size * n)``, then
  ``RandomState(rs).permutation(n)``; test is its head, train its tail;
- ``kfold_split`` (``KFold(k, shuffle=True, random_state=rs)``):
  ``RandomState(rs).shuffle(arange(n))`` cut into k folds, the first
  ``n % k`` one row longer; train and test indices come back sorted.
"""

from __future__ import annotations

import math

import numpy as np

from relaxtpu_torch.data.mos import mos_1_5_to_1_100
from relaxtpu_torch.utils.keywords import jax_keywords


def train_test_split(a, test_size: float, random_state: int | None):
    """sklearn's ``train_test_split(a, test_size=..., random_state=...)`` for
    one array and a float ``test_size`` -> (a[train], a[test])."""
    a = np.asarray(a)
    n = len(a)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size must be a float in (0, 1), got {test_size}")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the train set is empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return a[perm[n_test:]], a[perm[:n_test]]


def kfold_split(n: int, n_splits: int, random_state: int | None) -> list[tuple[np.ndarray, np.ndarray]]:
    """sklearn's ``list(KFold(n_splits, shuffle=True, random_state).split(range(n)))``."""
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater "
                         f"than the number of samples: n_samples={n}.")
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    folds, start = [], 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start : start + size]] = True
        folds.append((np.flatnonzero(~test), np.flatnonzero(test)))
        start += size
    return folds


def _drop_greyscale(meta: dict, features: np.ndarray, grey_indices):
    if grey_indices is None or len(grey_indices) == 0:
        return meta, features
    keep = np.ones(len(features), dtype=bool)
    keep[list(grey_indices)] = False
    return {k: v[keep] for k, v in meta.items()}, features[keep]


@jax_keywords(df="meta")
def split_other(meta: dict, features: np.ndarray, test_size: float, random_state: int | None,
                grey_indices=None):
    """Random holdout by unique vid, greyscale rows dropped first ->
    (x_train, y_train, x_test, y_test, test_vids); rows keep file order."""
    meta, features = _drop_greyscale(meta, features, grey_indices)
    vids = meta["vid"]
    unique_vids = np.array(list(dict.fromkeys(vids)), dtype=object)  # first-appearance order
    train_vids, test_vids = train_test_split(unique_vids, test_size, random_state)
    train_mask = np.isin(vids, train_vids)
    test_mask = np.isin(vids, test_vids)
    mos = np.asarray(meta["mos"], dtype=float)
    return features[train_mask], mos[train_mask], features[test_mask], mos[test_mask], test_vids


@jax_keywords(train_df="train_meta", test_df="test_meta")
def split_lsvq(train_meta: dict, test_meta: dict, train_features: np.ndarray,
               test_features: np.ndarray, grey_train=None, grey_test=None):
    """Fixed LSVQ train/test split."""
    train_meta, train_features = _drop_greyscale(train_meta, train_features, grey_train)
    test_meta, test_features = _drop_greyscale(test_meta, test_features, grey_test)
    y_train = np.asarray(train_meta["mos"], dtype=float)
    y_test = np.asarray(test_meta["mos"], dtype=float)
    return train_features, y_train, test_features, y_test, test_meta["vid"]


@jax_keywords(train_df="train_meta", test_df="test_meta")
def split_cross_dataset(train_meta: dict, test_meta: dict, train_features: np.ndarray,
                        test_features: np.ndarray, train_name: str = "youtube_ugc",
                        test_name: str = "cvd_2014", grey_train=None, grey_test=None):
    """Cross-dataset split; 1-5 MOS (konvid_1k, youtube_ugc) mapped to 1-100."""
    x_tr, y_tr, x_te, y_te, test_vids = split_lsvq(
        train_meta, test_meta, train_features, test_features, grey_train, grey_test)
    if train_name in ("konvid_1k", "youtube_ugc"):
        y_tr = mos_1_5_to_1_100(y_tr)
    if test_name in ("konvid_1k", "youtube_ugc"):
        y_te = mos_1_5_to_1_100(y_te)
    return x_tr, y_tr, x_te, y_te, test_vids

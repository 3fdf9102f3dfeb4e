"""Per-video feature store and feature matrices (own copy of
``relaxtpu/data/store.py:16-63``).

``FeatureStore`` reads and writes relaxtpu's per-video store
(``<root>/<dataset>/video_<i+1>.npy``, a per-frame matrix or a vector),
so each package reads the other's; ``save_mat`` exports the assembled
matrix in the reference's ``.mat`` format, keyed by dataset name.
``load_mat_features`` / ``load_chunked_features`` read such files
(LSVQ-train ships in chunks).
"""

from __future__ import annotations

import os

import numpy as np


class FeatureStore:
    def __init__(self, root: str):
        self.root = root

    def _path(self, dataset: str, index: int) -> str:
        return os.path.join(self.root, dataset, f"video_{index + 1}.npy")

    def has(self, dataset: str, index: int) -> bool:
        return os.path.exists(self._path(dataset, index))

    def put(self, dataset: str, index: int, per_frame: np.ndarray) -> None:
        """Write one video's features, creating ``<root>/<dataset>/``.  The
        file appears whole or not at all (written aside, then renamed), so
        a run cut short leaves nothing that ``has`` would take as done."""
        path = self._path(dataset, index)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            np.save(f, per_frame)
        os.replace(tmp, path)

    def get(self, dataset: str, index: int) -> np.ndarray:
        return np.load(self._path(dataset, index))

    def assemble(self, dataset: str, n_videos: int) -> np.ndarray:
        """(n_videos, D) matrix: mean over frames per video."""
        rows = []
        for i in range(n_videos):
            per_frame = self.get(dataset, i)
            rows.append(per_frame.mean(axis=0) if per_frame.ndim == 2 else per_frame)
        return np.stack(rows)

    def save_mat(self, dataset: str, n_videos: int, path: str, key: str | None = None) -> None:
        """The assembled matrix as a reference-format ``.mat`` under ``key``
        (default: the dataset)."""
        import scipy.io

        scipy.io.savemat(path, {key or dataset: self.assemble(dataset, n_videos)})


def load_mat_features(path: str, key: str) -> np.ndarray:
    import scipy.io

    return np.asarray(scipy.io.loadmat(path)[key], dtype=float)


def load_chunked_features(paths: list[str], key: str) -> np.ndarray:
    """The chunks stacked in order, as float64."""
    return np.vstack([load_mat_features(p, key) for p in paths])

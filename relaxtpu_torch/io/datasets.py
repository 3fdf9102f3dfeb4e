"""Dataset registry and metadata CSVs (own copy of
``relaxtpu/io/datasets.py:17-61``, read with the ``csv`` module).

A metadata table is a dict of columns in file order: ``vid`` as str,
``mos`` as float64, every other column as str.  Set ``RELAXTPU_DATA_ROOT``
(or pass ``root``) to point at ``<root>/<subdir>/<vid><ext>``.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    metadata_csv: str  # relative to the metadata dir
    subdir: str
    ext: str
    mos_scale: str  # '1-5' or '0-100'
    drop_greyscale: bool = False
    raw_yuv: bool = False

    def video_path(self, root: str, vid: str) -> str:
        return os.path.join(root, self.subdir, f"{vid}{self.ext}")


DATASET_REGISTRY: dict[str, DatasetSpec] = {
    "konvid_1k": DatasetSpec("konvid_1k", "KONVID_1K_metadata.csv", "KoNViD_1k_videos", ".mp4", "1-5"),
    "live_vqc": DatasetSpec("live_vqc", "LIVE_VQC_metadata.csv", "LIVE-VQC/video", ".mp4", "0-100"),
    "cvd_2014": DatasetSpec("cvd_2014", "CVD_2014_metadata.csv", "CVD2014", ".avi", "0-100"),
    "youtube_ugc": DatasetSpec(
        "youtube_ugc", "YOUTUBE_UGC_metadata.csv", "youtube_ugc", ".mkv", "1-5", drop_greyscale=True
    ),
    "live_qualcomm": DatasetSpec(
        "live_qualcomm", "LIVE_QUALCOMM_metadata.csv", "LIVE-Qualcomm", ".yuv", "0-100", raw_yuv=True
    ),
    "lsvq_train": DatasetSpec("lsvq_train", "LSVQ_TRAIN_metadata.csv", "LSVQ", ".mp4", "0-100"),
    "lsvq_test": DatasetSpec("lsvq_test", "LSVQ_TEST_metadata.csv", "LSVQ", ".mp4", "0-100"),
    "lsvq_test_1080P": DatasetSpec(
        "lsvq_test_1080P", "LSVQ_TEST_1080P_metadata.csv", "LSVQ", ".mp4", "0-100"
    ),
}


def get_dataset(name: str) -> DatasetSpec:
    try:
        return DATASET_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)}")


def data_root(override: str | None = None) -> str:
    return override or os.environ.get("RELAXTPU_DATA_ROOT", ".")


def read_metadata_csv(path: str) -> dict[str, np.ndarray]:
    """A metadata CSV -> {column: array}, rows in file order."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    cols = {k: np.array([r[i] for r in rows], dtype=object) for i, k in enumerate(header)}
    if "mos" in cols:
        cols["mos"] = cols["mos"].astype(np.float64)
    return cols


def load_metadata(spec: DatasetSpec, metadata_dir: str) -> dict[str, np.ndarray]:
    return read_metadata_csv(os.path.join(metadata_dir, spec.metadata_csv))

"""Greyscale-video detection and the report of greyscale rows (own copy of
``relaxtpu/data/greyscale.py``, the report written with the ``csv``
module).

A frame is greyscale when its largest inter-channel difference is <= 3; a
video is greyscale when every frame read is.  Videos are read through cv2,
as in the JAX package, so both give the same report; cv2 is imported only
when a video is checked.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from relaxtpu_torch.utils.keywords import jax_keywords

REPORT_COLUMNS = ["Index", "vid", "Is Greyscale"]


def is_greyscale_image(img_bgr: np.ndarray, tol: int = 3) -> bool:
    img = img_bgr.astype(np.int32)
    d1 = np.abs(img[..., 0] - img[..., 1]).max()
    d2 = np.abs(img[..., 1] - img[..., 2]).max()
    d3 = np.abs(img[..., 0] - img[..., 2]).max()
    return bool(max(d1, d2, d3) <= tol)


def video_is_greyscale(frames_bgr: np.ndarray, tol: int = 3) -> bool:
    return all(is_greyscale_image(f, tol) for f in frames_bgr)


def check_video_file_greyscale(path: str, tol: int = 3) -> tuple[bool, bool]:
    """(is_greyscale, any_frame_read) of a video file, stopping at the first
    colour frame."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"the greyscale check reads videos through cv2, which is not installed ({e})") from None
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return False, False
    frame_read, grey = False, True
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame_read = True
            if not is_greyscale_image(frame, tol):
                grey = False
                break
    finally:
        cap.release()
    return grey and frame_read, frame_read


@jax_keywords(df="meta")
def greyscale_report(meta: dict, video_path_fn, tol: int = 3, progress=None) -> list[dict]:
    """The greyscale rows of a metadata table (``io.datasets``' column
    dict) -> report rows {Index, vid, Is Greyscale}; Index is the metadata
    row index that the split protocols drop."""
    rows = []
    for i, vid in enumerate(meta["vid"]):
        grey, read = check_video_file_greyscale(video_path_fn(vid), tol)
        if progress:
            progress(f"{vid}: greyscale={grey} readable={read}")
        if grey:
            rows.append({"Index": i, "vid": vid, "Is Greyscale": True})
    return rows


def write_report(path: str, rows: list[dict]) -> None:
    """The report CSV (header ``Index,vid,Is Greyscale``)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(REPORT_COLUMNS)
        writer.writerows([r[c] for c in REPORT_COLUMNS] for r in rows)


def load_grey_indices(report_csv: str) -> list[int]:
    """Metadata row indices from the first column of a greyscale report
    CSV; [] when the file is absent."""
    if not os.path.exists(report_csv):
        return []
    with open(report_csv, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return [int(r[0]) for r in rows if r]

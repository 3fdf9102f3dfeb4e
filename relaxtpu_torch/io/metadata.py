"""Dataset metadata tables (counterpart of ``relaxtpu/io/metadata.py``,
with the ``csv`` module in place of pandas).

The table the pipeline reads has the reference's columns: vid, mos, width,
height, pixfmt, framerate, nb_frames, bitdepth, bitrate.  Four flows fill
it, as in the JAX package:

- a directory scan that probes every container (KoNViD-1k, YouTube-UGC);
- an info ``.mat`` (CVD2014 ``.avi`` probed; LIVE-Qualcomm raw 1080p
  ``.yuv`` described from its size and geometry);
- a LIVE-VQC CSV passed through;
- an LSVQ CSV whose listed videos are probed.

A table is ``(columns, rows)``, rows as dicts.  :func:`write_csv` writes
it as pandas' ``to_csv(index=False)`` writes the JAX package's frame, so
both give the same file: a column's values are typed as pandas infers them
(ints, floats where a value is missing or a float, else strings) and
missing values are empty.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np

from relaxtpu_torch.io.video import probe_video

COLUMNS = ["vid", "mos", "width", "height", "pixfmt", "framerate", "nb_frames", "bitdepth", "bitrate"]
# pandas.read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
       "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _probe_row(vid: str, path: str, mos=None) -> dict:
    info = probe_video(path)
    return {"vid": vid, "mos": mos, "width": info["width"], "height": info["height"],
            "pixfmt": info.get("pixfmt", "yuv420p"), "framerate": info["framerate"],
            "nb_frames": info["nb_frames"], "bitdepth": info.get("bitdepth", 8),
            "bitrate": info.get("bitrate")}


def _yuv_row(vid: str, path: str, mos=None, width=1920, height=1080, pixfmt="yuv420p",
             framerate=None) -> dict:
    """A raw .yuv file from its geometry and size (no codec to probe)."""
    frame_bytes = width * height * 3 // 2
    return {"vid": vid, "mos": mos, "width": width, "height": height, "pixfmt": pixfmt,
            "framerate": framerate, "nb_frames": int(os.path.getsize(path) // frame_bytes),
            "bitdepth": 8, "bitrate": int(frame_bytes * 8 * framerate) if framerate else None}


def extract_metadata(video_dir: str, exts=(".mp4", ".mkv", ".avi")) -> tuple[list, list]:
    """Directory scan: every container probed; a file that fails gets a row
    with its ``error``."""
    rows = []
    for fname in sorted(os.listdir(video_dir)):
        base, ext = os.path.splitext(fname)
        if ext.lower() not in exts:
            continue
        try:
            rows.append(_probe_row(base, os.path.join(video_dir, fname)))
        except (OSError, RuntimeError, ValueError) as e:  # unreadable file, no decoder, bad stream
            rows.append({"vid": base, "error": str(e)})
    columns = []
    for r in rows:  # pandas' order: the columns as they first appear
        columns += [k for k in r if k not in columns]
    return columns, rows


def np_item(cell):
    """A (possibly nested) MATLAB cell entry -> a scalar or str."""
    a = np.asarray(cell)
    while a.dtype == object:
        a = np.asarray(a.flat[0])
    return a.item() if a.ndim == 0 else a.flat[0].item()


def metadata_from_info_mat(mat_file: str, video_dir: str, video_type: str = "cvd_2014",
                           framerate_hint: float | None = None) -> tuple[list, list]:
    """CVD2014 / LIVE-Qualcomm info ``.mat`` (``video_names``, ``scores``)."""
    import scipy.io

    data = scipy.io.loadmat(mat_file)
    names, scores = data["video_names"], data["scores"]
    rows = []
    for i in range(len(names)):
        vid, mos = str(np_item(names[i])), float(np_item(scores[i]))
        if video_type == "live_qualcomm":
            base = vid[:-4] if vid.endswith(".yuv") else vid
            rows.append(_yuv_row(base, os.path.join(video_dir, base + ".yuv"), mos, framerate=framerate_hint))
        else:
            base = vid[:-4] if vid.endswith(".avi") else vid
            rows.append(_probe_row(base, os.path.join(video_dir, base + ".avi"), mos))
    return COLUMNS, rows


def _parse_cell(s: str, kind: str):
    if s in _NA:
        return None
    return int(s) if kind == "int" else float(s) if kind == "float" else s


def _kind_of(cells: list[str]) -> str:
    """The type pandas.read_csv gives a column of these cells."""
    present = [c for c in cells if c not in _NA]
    for kind, cast in (("int", int), ("float", float)):
        try:
            [cast(c) for c in present]
        except ValueError:
            continue
        return "float" if kind == "int" and len(present) < len(cells) else kind
    return "str"


def read_typed_csv(path: str) -> tuple[list, list]:
    """A CSV -> (columns, rows) with each column typed as pandas.read_csv
    types it (int, float, or str; missing values None)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        columns = next(reader)
        cells = list(reader)
    kinds = [_kind_of([r[j] for r in cells]) for j in range(len(columns))]
    return columns, [{c: _parse_cell(r[j], k) for j, (c, k) in enumerate(zip(columns, kinds))}
                     for r in cells]


def metadata_from_csv(csv_file: str, video_dir: str | None = None, video_type: str = "live_vqc",
                      name_col: str | None = None, mos_col: str = "mos") -> tuple[list, list]:
    """LIVE-VQC: the CSV passed through (vid without ``.mp4``); LSVQ: every
    listed video on disk probed, its width, height and frame count from the
    CSV where it has them."""
    columns, src = read_typed_csv(csv_file)
    if video_type == "live_vqc":
        keep = [c for c in COLUMNS if c in columns]
        rows = [{c: r[c] for c in keep} for r in src]
        for r in rows:
            r["vid"] = str(r["vid"]).replace(".mp4", "")
        return keep, rows
    name_col = name_col or ("name" if "name" in columns else "vid")
    rows = []
    for r in src:
        path = os.path.join(video_dir or "", f"{r[name_col]}.mp4")
        if not os.path.exists(path):
            continue
        row = _probe_row(str(r[name_col]), path, r.get(mos_col))
        for src_col, dst in (("width", "width"), ("height", "height"), ("frame_number", "nb_frames")):
            if src_col in columns:
                row[dst] = r[src_col]
        rows.append(row)
    return COLUMNS, rows


def _missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _column_text(values: list) -> list[str]:
    """A column's cells as pandas writes them: ints as ints unless a value
    is missing or a float (then every number as a float), else str."""
    present = [v for v in values if not _missing(v)]
    numbers = all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_))
                  for v in present)
    ints = numbers and all(isinstance(v, (int, np.integer)) for v in present)
    if present and ints and len(present) == len(values):
        return [str(int(v)) for v in values]
    if present and numbers:
        return ["" if _missing(v) else repr(float(v)) for v in values]
    return ["" if _missing(v) else str(v) for v in values]


def write_csv(path: str, columns: list, rows: list) -> None:
    """The table as pandas' ``DataFrame(rows, columns=columns).to_csv(path,
    index=False)`` writes it."""
    cols = [_column_text([r.get(c) for r in rows]) for c in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*cols) if rows else [])

"""relaxtpu_torch CLI (counterpart of ``relaxtpu/cli/__main__.py``).

Subcommands ``predict`` (one video), ``predict-batch`` (many videos,
streamed or batched) and ``serve`` (JSON lines on stdin).  The port reads
raw I420 ``.yuv`` files only, so each takes the clip geometry as flags.
Example::

    python -m relaxtpu_torch.cli predict --video v.yuv --width 960 \
        --height 540 --framerate 24 --model mlp.npz \
        --imputer konvid_1k_imputer.pkl --scaler konvid_1k_scaler.pkl
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import csv
import glob
import itertools
import json
import logging
import os
import sys

import torch

from relaxtpu_torch.io.video import decode_video_inputs_i420

log = logging.getLogger("relaxtpu_torch.cli")


def _build_extractor(args):
    from relaxtpu_torch.device import default_dtype, resolve_device
    from relaxtpu_torch.features.pipeline import FeatureExtractor
    from relaxtpu_torch.models.initutil import random_init_
    from relaxtpu_torch.models.resnet import ResNet50
    from relaxtpu_torch.models.vit import ViT
    from relaxtpu_torch.utils.checkpoint import load_torch_state

    device = resolve_device(args.device)
    states = []
    for path, net, seed, what in (
        (args.resnet_weights, ResNet50(), 0, "ResNet-50"),
        (args.vit_weights, ViT(), 1, "ViT"),
    ):
        if path:
            states.append(load_torch_state(path, net.state_dict().keys()))
        else:
            logging.warning("no weights given: using seeded random %s weights", what)
            states.append(random_init_(net, seed).state_dict())
    return FeatureExtractor(*states, dtype=default_dtype(device, args.bf16), device=device)


def _load_predictor(args, extractor):
    from relaxtpu_torch.model.mlp import fix_state_dict
    from relaxtpu_torch.model.scalers import FeatureScaler
    from relaxtpu_torch.models.porters import mlp_from_jax
    from relaxtpu_torch.predict import VideoQualityPredictor
    from relaxtpu_torch.utils.checkpoint import load_snapshot_variables

    if args.model.endswith(".npz"):
        mlp_state = mlp_from_jax(load_snapshot_variables(args.model))
    else:  # reference .pth
        sd = torch.load(args.model, map_location="cpu", weights_only=True)
        mlp_state = fix_state_dict(sd)
    scaler = FeatureScaler.load_reference_pkls(args.imputer, args.scaler)
    return VideoQualityPredictor(
        extractor, mlp_state, scaler, video_type=args.video_type, is_finetune=args.finetuned
    )


def serve_loop(predictor, requests, out, in_flight: int = 2, defaults: dict | None = None) -> None:
    """The scoring server: JSON-lines requests -> JSON-lines responses.

    A request is a bare path or ``{"video", "framerate", "width",
    "height"}``; fields it lacks come from ``defaults``.  ``out`` gets
    ``{"status": "ready"}`` first, then one response a request, in request
    order: ``{"video", "predicted_mos"}`` or ``{"video", "error"}``.  Up to
    ``in_flight`` videos stay enqueued on the device while later requests
    decode on the host.
    """
    defaults = defaults or {}
    pending = collections.deque()  # (video, pending vector, error)

    def emit(video, vec, err):
        if err is None:
            try:
                row = {"video": video, "predicted_mos": predictor.predict_feature(vec)}
            except Exception as e:  # a device fault surfaces at the fetch
                log.exception("scoring %s failed", video)
                row = {"video": video, "error": str(e)}
        else:
            row = {"video": video, "error": err}
        out.write(json.dumps(row) + "\n")
        out.flush()

    out.write(json.dumps({"status": "ready"}) + "\n")
    out.flush()
    for line in requests:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line) if line.startswith("{") else {"video": line}
            if not isinstance(req, dict) or "video" not in req:
                raise ValueError("a request is a path or {'video': path, ...}")
        except ValueError as e:
            pending.append((None, None, f"bad request: {e}"))
        else:
            geometry = {k: req.get(k, defaults.get(k)) for k in ("framerate", "width", "height")}
            try:
                pending.append((req["video"], predictor.enqueue_file(req["video"], **geometry), None))
            except Exception as e:  # one bad request must not stop the server
                log.exception("request for %s failed", req["video"])
                pending.append((req["video"], None, str(e)))
        while len(pending) > in_flight:
            emit(*pending.popleft())
    while pending:
        emit(*pending.popleft())


def predict_batch(predictor, paths, framerate, width, height, batch: int = 1,
                  decode_workers: int = 4) -> list[tuple[str, float]]:
    """MOS of every raw I420 file in ``paths`` -> [(path, mos)] in input order.

    Host threads decode ahead of the device.  ``batch`` 1 sends each video
    through the single-video program; ``batch`` N > 1 sends runs of N
    videos through the batched program.  Two programs stay enqueued while
    the next run decodes.  Every file shares one geometry,
    so every run is of one resolution.
    """
    extractor = predictor.extractor
    mos, pending = [], collections.deque()
    with cf.ThreadPoolExecutor(max_workers=decode_workers) as pool:
        decoded = pool.map(lambda p: decode_video_inputs_i420(p, framerate, width, height), paths)
        while run := list(itertools.islice(decoded, max(batch, 1))):
            h, w = run[0][2], run[0][3]
            if len(run) == 1:
                vecs = extractor.video_feature_async_i420(*run[0])[None]
            else:
                vecs = extractor.video_features_batch_i420([d[0] for d in run], [d[1] for d in run], h, w)
            pending.append(vecs)
            while len(pending) > 2:
                mos += [predictor.predict_feature(v) for v in pending.popleft().cpu()]
        while pending:
            mos += [predictor.predict_feature(v) for v in pending.popleft().cpu()]
    return list(zip(paths, mos))


def _video_paths(items) -> list[str]:
    paths = []
    for v in items:
        paths += sorted(glob.glob(os.path.join(v, "*.yuv"))) if os.path.isdir(v) else [v]
    if not paths:
        raise SystemExit("no videos found")
    return paths


def cmd_predict(args):
    predictor = _load_predictor(args, _build_extractor(args))
    mos = predictor.predict_file(args.video, framerate=args.framerate,
                                 width=args.width, height=args.height)
    print(json.dumps({"video": args.video, "predicted_mos": mos}))


def cmd_predict_batch(args):
    paths = _video_paths(args.videos)
    predictor = _load_predictor(args, _build_extractor(args))
    rows = predict_batch(predictor, paths, args.framerate, args.width, args.height,
                         batch=args.batch, decode_workers=args.decode_workers)
    for path, mos in rows:
        print(json.dumps({"video": path, "predicted_mos": mos}))
    if args.output_csv:
        with open(args.output_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["video", "predicted_mos"])
            writer.writerows(rows)


def cmd_serve(args):
    predictor = _load_predictor(args, _build_extractor(args))
    serve_loop(predictor, sys.stdin, sys.stdout, args.in_flight,
               dict(framerate=args.framerate, width=args.width, height=args.height))


def _add_model_flags(sp) -> None:
    sp.add_argument("--video-type", default="konvid_1k")
    sp.add_argument("--model", required=True, help=".npz snapshot or reference .pth")
    sp.add_argument("--imputer", required=True)
    sp.add_argument("--scaler", required=True)
    sp.add_argument("--finetuned", action="store_true")
    sp.add_argument("--resnet-weights", default=None, help="torchvision resnet50 .pth")
    sp.add_argument("--vit-weights", default=None, help="DINO ViT-B/16 .pth")
    grp = sp.add_mutually_exclusive_group()
    grp.add_argument("--bf16", dest="bf16", action="store_true", default=None,
                     help="bfloat16 backbones (the default on CUDA)")
    grp.add_argument("--f32", dest="bf16", action="store_false",
                     help="float32 backbones with TF32 off (strict-parity mode)")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_geometry_flags(sp, what: str) -> None:
    sp.add_argument("--framerate", type=float, default=None, help=f"frame rate of {what}")
    sp.add_argument("--width", type=int, default=None, help=f"width of {what}")
    sp.add_argument("--height", type=int, default=None, help=f"height of {what}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="relaxtpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("predict", help="one raw I420 .yuv video -> MOS")
    sp.add_argument("--video", required=True)
    _add_model_flags(sp)
    _add_geometry_flags(sp, "the raw video")
    sp.add_argument("--ingest", default="auto", choices=["bgr", "yuv", "auto"],
                    help="accepted for compatibility: a .yuv file gives the same "
                    "frames in every mode (the device converter bit-matches the "
                    "host one)")
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser(
        "predict-batch", help="MOS for many raw I420 .yuv videos, streamed or batched",
        description="Unlike the JAX CLI, this one reads raw I420 .yuv files only (a "
        "directory means its *.yuv files), so --framerate, --width and --height are "
        "required and apply to every video.",
    )
    sp.add_argument("--videos", nargs="+", required=True,
                    help=".yuv files and/or directories of them")
    _add_model_flags(sp)
    _add_geometry_flags(sp, "every video")
    sp.add_argument("--batch", type=int, default=1,
                    help="videos a device program: 1 (default) streams each video through "
                    "the single-video program, N > 1 sends runs of N videos through the "
                    "batched program; either way 2 programs stay enqueued")
    sp.add_argument("--decode-workers", type=int, default=4, help="host decode threads")
    sp.add_argument("--output-csv", default=None, help="also write a video,predicted_mos CSV")
    sp.set_defaults(fn=cmd_predict_batch)

    sp = sub.add_parser(
        "serve", help="scoring server: JSON-lines requests on stdin -> JSON lines on stdout",
        description="A request is a bare .yuv path or {\"video\", \"framerate\", \"width\", "
        "\"height\"}; the geometry flags fill what a request lacks.",
    )
    _add_model_flags(sp)
    _add_geometry_flags(sp, "requests that do not give it")
    sp.add_argument("--in-flight", type=int, default=2,
                    help="videos left enqueued on the device while later requests decode")
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

"""relaxtpu_torch CLI (counterpart of ``relaxtpu/cli/__main__.py``).

This slice ports the ``predict`` subcommand: one raw I420 ``.yuv`` video ->
MOS, printed as one JSON line.  Example::

    python -m relaxtpu_torch.cli predict --video v.yuv --width 960 \
        --height 540 --framerate 24 --model mlp.npz \
        --imputer konvid_1k_imputer.pkl --scaler konvid_1k_scaler.pkl
"""

from __future__ import annotations

import argparse
import json
import logging

import torch


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


def cmd_predict(args):
    predictor = _load_predictor(args, _build_extractor(args))
    mos = predictor.predict_file(args.video, framerate=args.framerate,
                                 width=args.width, height=args.height)
    print(json.dumps({"video": args.video, "predicted_mos": mos}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="relaxtpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("predict", help="one raw I420 .yuv video -> MOS")
    sp.add_argument("--video", required=True)
    sp.add_argument("--video-type", default="konvid_1k")
    sp.add_argument("--model", required=True, help=".npz snapshot or reference .pth")
    sp.add_argument("--imputer", required=True)
    sp.add_argument("--scaler", required=True)
    sp.add_argument("--finetuned", action="store_true")
    sp.add_argument("--framerate", type=float, default=None)
    sp.add_argument("--width", type=int, default=None)
    sp.add_argument("--height", type=int, default=None)
    sp.add_argument("--ingest", default="auto", choices=["bgr", "yuv", "auto"],
                    help="accepted for compatibility: a .yuv file gives the same "
                    "frames in every mode (the device converter bit-matches the "
                    "host one)")
    sp.add_argument("--resnet-weights", default=None, help="torchvision resnet50 .pth")
    sp.add_argument("--vit-weights", default=None, help="DINO ViT-B/16 .pth")
    grp = sp.add_mutually_exclusive_group()
    grp.add_argument("--bf16", dest="bf16", action="store_true", default=None,
                     help="bfloat16 backbones (the default on CUDA)")
    grp.add_argument("--f32", dest="bf16", action="store_false",
                     help="float32 backbones with TF32 off (strict-parity mode)")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_predict)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

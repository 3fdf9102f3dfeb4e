"""Strict-parity checks against the reference (counterpart of
``relaxtpu/parity.py``): one command that diffs the port against the
reference's shipped artifacts once they are at hand, and against an
independent reference stack and the card's own f32 run before then.

- ``head_parity``: from the reference's features ``.mat``, metadata CSV,
  results ``.mat`` (the median split), median-model ``.pth`` and fitted
  imputer/scaler ``.pkl``s, the median model's test predictions with the
  port's MLP (f32, TF32 off), diffed against the shipped
  ``{dataset}_relaxvqa_byrmse.csv``; |diff| <= ``HEAD_TOL`` on the 0-100
  scale.
- ``feature_parity``: the whole f32 pipeline on the device against the
  torch + cv2 + PIL reference of ``oracle.py`` on the CPU, with the same
  weights, per segment.
- ``demo_parity``: the whole f32 prediction of one video, diffed against an
  expected MOS within ``DEMO_TOL``.
- ``production_numerics``: the numerics the port ships on its device:
  Farneback flow (kernels K1 and K2 on CUDA) against cv2, and the bf16
  35,203 vector against the f32 one, with the JAX package's images,
  parameters and bounds.
- ``all_parity``: every check whose inputs are present, one verdict.

Each takes ``device``: CUDA by default, raising without it; ``"cpu"`` runs
the kernels' plain versions.  The reference's ``.pkl``s need joblib.
"""

from __future__ import annotations

import csv
import dataclasses
import json

import numpy as np
import torch

from relaxtpu_torch.device import resolve_device, set_strict_f32

HEAD_TOL = 0.05   # |diff of a prediction| on the reference's own test split
DEMO_TOL = 0.1    # |diff of the MOS| end to end


@dataclasses.dataclass
class ParityReport:
    n: int
    max_abs_diff: float
    mean_abs_diff: float
    tolerance: float

    @property
    def ok(self) -> bool:
        return self.max_abs_diff <= self.tolerance

    def to_json(self) -> str:
        return json.dumps({"n": self.n, "max_abs_diff": self.max_abs_diff, "mean_abs_diff": self.mean_abs_diff,
                           "tolerance": self.tolerance, "ok": self.ok})


def _median_test_vids(result_mat: str) -> list[str]:
    """The median model's test videos from a results ``.mat``, its MATLAB
    cell nesting flattened; an integral float reads as an int ('3000.0'
    becomes '3000')."""
    import scipy.io

    raw = scipy.io.loadmat(result_mat, squeeze_me=True)["Test_videos_Median_model"]

    def flat(v):
        if isinstance(v, bytes):
            yield v.decode().strip()
        elif isinstance(v, str):
            yield v.strip()
        elif isinstance(v, (int, np.integer)):
            yield str(int(v))
        elif isinstance(v, (float, np.floating)):
            yield str(int(v)) if float(v).is_integer() else str(v)
        else:
            for x in np.asarray(v).ravel():
                yield from flat(x)

    return list(flat(raw))


def _load_pth(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def head_parity(
    dataset: str,
    features_mat: str,
    metadata_csv: str,
    result_mat: str,
    model_pth: str,
    imputer_pkl: str,
    scaler_pkl: str,
    expected_csv: str,
    greyscale_report: str | None = None,
    use_bn: bool = True,
    device=None,
) -> ParityReport:
    """The median model's test predictions, recomputed, against the shipped CSV."""
    from relaxtpu_torch.data.greyscale import load_grey_indices
    from relaxtpu_torch.data.recover import recover_median_split
    from relaxtpu_torch.data.store import load_mat_features
    from relaxtpu_torch.io.datasets import read_metadata_csv
    from relaxtpu_torch.model.mlp import Mlp, fix_state_dict
    from relaxtpu_torch.model.scalers import FeatureScaler

    dev = resolve_device(device)
    meta = read_metadata_csv(metadata_csv)
    features = load_mat_features(features_mat, dataset)
    if greyscale_report:
        grey = load_grey_indices(greyscale_report)
        if grey:
            meta = {k: np.delete(v, grey) for k, v in meta.items()}
            features = np.delete(features, grey, axis=0)
    _, _, x_test, _ = recover_median_split(meta, features, _median_test_vids(result_mat))
    x = FeatureScaler.load_reference_pkls(imputer_pkl, scaler_pkl).transform(x_test).astype(np.float32)

    state = fix_state_dict(_load_pth(model_pth))
    if not use_bn:
        state = {k: v for k, v in state.items() if not k.startswith("bn1.")}
    mlp = Mlp(in_features=state["fc1.weight"].shape[1], use_bn=use_bn)
    mlp.load_state_dict(state)
    set_strict_f32()  # the JAX package pins matmul precision "highest" here
    with torch.inference_mode():
        y_pred = mlp.to(dev).eval()(torch.from_numpy(x).to(dev)).reshape(-1).double().cpu().numpy()

    with open(expected_csv, newline="") as f:
        expected = np.array([float(r["y_test_pred"]) for r in csv.DictReader(f)])
    if len(expected) != len(y_pred):
        raise ValueError(
            f"row-count mismatch: recovered split has {len(y_pred)} test videos, "
            f"expected csv has {len(expected)} — check metadata/greyscale inputs"
        )
    diff = np.abs(y_pred - expected)
    return ParityReport(len(diff), float(diff.max()), float(diff.mean()), HEAD_TOL)


def synthetic_correlated_video(rng, n_frames: int, h: int, w: int):
    """Temporally correlated (frames, next) BGR stacks, so that flow and
    fragments do real work: a blurred random texture panned a few pixels a
    frame, plus noise (the JAX package's generator, draw for draw)."""
    import cv2

    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h + 24, w + 24, 3), dtype=np.uint8).astype(np.float32), (0, 0), 2,
    )
    chain = []
    for i in range(2 * n_frames):
        ox, oy = int(8 + 6 * np.sin(i / 3)), int(8 + 5 * np.cos(i / 4))
        chain.append(np.clip(base[oy : oy + h, ox : ox + w] + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8))
    chain = np.stack(chain)
    return np.ascontiguousarray(chain[0::2]), np.ascontiguousarray(chain[1::2])


# per-segment bounds (cosine >=, mean |diff| / mean |reference| <=), the JAX package's
FEATURE_TOL = {"resnet_stack": (0.9999, 5e-3), "vit_pool": (0.9999, 5e-3),
               "frag_resnet": (0.9999, 5e-3), "frag_vit": (0.9999, 5e-3)}


def feature_parity(
    video: str | None,
    resnet_weights: str | None = None,
    vit_weights: str | None = None,
    n_frames: int = 3,
    device=None,
) -> dict:
    """The 35,203 vector of the f32 pipeline on ``device`` against the
    independent reference of ``oracle.py`` on the CPU, on the same frames (a
    video's first ``n_frames``, or synthetic 120x160 ones) with the same
    weights (the given ``.pth`` files, else seeded random ones); per-segment
    cosine and relative error against ``FEATURE_TOL``."""
    from relaxtpu_torch.features.pipeline import FeatureExtractor
    from relaxtpu_torch.oracle import build_torch_resnet50, build_torch_vit, compare_segments, reference_video_feature

    dev = resolve_device(device)
    rn_oracle = build_torch_resnet50(_load_pth(resnet_weights) if resnet_weights else None, seed=0)
    vit_oracle = build_torch_vit(_load_pth(vit_weights) if vit_weights else None, seed=1)
    fx = FeatureExtractor(rn_oracle.state_dict(), vit_oracle.state_dict(), dtype=torch.float32, device=dev)

    if video:
        from relaxtpu_torch.io.video import decode_video_inputs

        frames, _, nxt = decode_video_inputs(video)
        frames, nxt = frames[:n_frames], nxt[:n_frames]
    else:
        frames, nxt = synthetic_correlated_video(np.random.default_rng(0), n_frames, 120, 160)
    prev = frames[: len(nxt)]

    # strict f32: the reference side is exact f32, and TF32 keeps about
    # three decimal digits (the JAX package pins matmul precision "highest")
    set_strict_f32()
    ours = fx.video_feature(frames, prev, nxt)
    theirs = reference_video_feature(frames, nxt, rn_oracle, vit_oracle)
    report = compare_segments(ours, theirs)
    ok = all(report[s]["cosine"] >= c and report[s]["mean_abs_err_over_mean_abs"] <= m
             for s, (c, m) in FEATURE_TOL.items())
    return {
        "video": video or "<synthetic>",
        "n_frames": int(len(frames)),
        "weights": "pretrained" if resnet_weights else "seeded-random",
        "segments": report,
        "ok": ok,
    }


def demo_parity(
    video: str,
    video_type: str,
    model_pth: str,
    imputer_pkl: str,
    scaler_pkl: str,
    resnet_weights: str,
    vit_weights: str,
    expected_mos: float | None = None,
    device=None,
) -> dict:
    """The whole f32 prediction of one video; its MOS diffed against
    ``expected_mos`` where given."""
    from relaxtpu_torch.features.pipeline import FeatureExtractor
    from relaxtpu_torch.model.mlp import fix_state_dict
    from relaxtpu_torch.model.scalers import FeatureScaler
    from relaxtpu_torch.models.resnet import ResNet50
    from relaxtpu_torch.models.vit import ViT
    from relaxtpu_torch.predict import VideoQualityPredictor
    from relaxtpu_torch.utils.checkpoint import load_torch_state

    fx = FeatureExtractor(
        load_torch_state(resnet_weights, ResNet50().state_dict().keys()),
        load_torch_state(vit_weights, ViT().state_dict().keys()),
        dtype=torch.float32, device=device,
    )
    predictor = VideoQualityPredictor(fx, fix_state_dict(_load_pth(model_pth)),
                                      FeatureScaler.load_reference_pkls(imputer_pkl, scaler_pkl),
                                      video_type=video_type)
    mos = predictor.predict_file(video)
    out = {"video": video, "predicted_mos": mos, "tolerance": DEMO_TOL}
    if expected_mos is not None:
        out["expected_mos"] = expected_mos
        out["abs_diff"] = abs(mos - expected_mos)
        out["ok"] = out["abs_diff"] <= DEMO_TOL
    return out


def production_numerics(seed: int = 0, device=None) -> dict:
    """The numerics the port ships, measured on ``device``.

    - Farneback flow (f32; kernels K1 and K2 on CUDA) against
      ``cv2.calcOpticalFlowFarneback`` on a smooth 120x160 pair shifted by
      (1, 2) px: mean and p99 error in px over the interior (24 px in from
      each edge, where cv2's border rule differs); bounds 5e-3 and 5e-2.
    - The 35,203 vector with bf16 backbones against f32 (TF32 off) on 5
      random 120x160 frames and 4 pairs, seeded random full-depth
      ResNet-50 and ViT-B/16: cosine >= 0.9999 and median relative error
      (|diff| / max(|f32|, 1e-3)) <= 5e-2.

    The images, parameters and bounds are the JAX package's, which measures
    its own shipped numerics (the TPU's default matmul precision) the same way.
    """
    from relaxtpu_torch.features.pipeline import FeatureExtractor
    from relaxtpu_torch.models.initutil import random_init_
    from relaxtpu_torch.models.resnet import ResNet50
    from relaxtpu_torch.models.vit import ViT
    from relaxtpu_torch.ops.flow import farneback_flow

    dev = resolve_device(device)
    out: dict = {"device": str(dev)}
    rng = np.random.default_rng(seed)
    try:
        import cv2
    except ImportError as e:
        out["flow_skipped"] = f"cv2 unavailable: {e}"
    else:
        from scipy.ndimage import gaussian_filter

        big = gaussian_filter(rng.normal(0, 60, (140, 180)).astype(np.float32), 1.5) + 128
        prev = np.clip(big[8:-12, 8:-12], 0, 255).astype(np.uint8)
        nxt = np.clip(big[7:-13, 6:-14], 0, 255).astype(np.uint8)
        want = cv2.calcOpticalFlowFarneback(prev, nxt, None, 0.5, 3, 15, 3, 5, 1.2, 0)
        got = farneback_flow(torch.from_numpy(prev)[None].to(dev), torch.from_numpy(nxt)[None].to(dev),
                             pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
                             poly_sigma=1.2)[0].cpu().numpy()
        s = 24
        err = np.abs(got[s:-s, s:-s] - want[s:-s, s:-s])
        out["flow_mean_err_px"] = float(err.mean())
        out["flow_p99_err_px"] = float(np.percentile(err, 99))
        out["flow_ok"] = out["flow_mean_err_px"] <= 5e-3 and out["flow_p99_err_px"] <= 5e-2

    rn_state = random_init_(ResNet50(), 0).state_dict()
    vit_state = random_init_(ViT(), 1).state_dict()
    h, w, n = 120, 160, 5
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    nxt_f = np.roll(frames[: n - 1], (2, -3), axis=(1, 2))
    prev_f = frames[: n - 1]
    vecs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fx = FeatureExtractor(rn_state, vit_state, dtype=dtype, device=dev)
        vecs[name] = fx.video_feature(frames, prev_f, nxt_f).astype(np.float64)
    a, b = vecs["f32"], vecs["bf16"]
    out["bf16_cosine"] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    out["bf16_median_rel"] = float(np.median(np.abs(a - b) / np.maximum(np.abs(a), 1e-3)))
    out["bf16_ok"] = out["bf16_cosine"] >= 0.9999 and out["bf16_median_rel"] <= 5e-2
    out["ok"] = out.get("flow_ok", True) and out["bf16_ok"]
    return out


def all_parity(args) -> dict:
    """Every check whose inputs are present, one JSON verdict: ``features``
    and ``production`` always run; ``head`` runs given --features-mat,
    --metadata-csv, --result-mat, --model, --imputer, --scaler and
    --expected-csv, ``demo`` given --video, --model, --imputer, --scaler and
    both backbone weights, and each is skipped otherwise with the missing
    flags named.  ``ok`` holds over the checks that ran."""
    out: dict = {"checks": {}}
    out["checks"]["features"] = feature_parity(args.video, args.resnet_weights, args.vit_weights,
                                               device=args.device)

    head_flags = {
        "--features-mat": args.features_mat, "--metadata-csv": args.metadata_csv,
        "--result-mat": args.result_mat, "--model": args.model, "--imputer": args.imputer,
        "--scaler": args.scaler, "--expected-csv": args.expected_csv,
    }
    missing = sorted(k for k, v in head_flags.items() if not v)
    if missing:
        out["checks"]["head"] = {"skipped": f"missing {' '.join(missing)}"}
    else:
        report = head_parity(
            args.dataset, args.features_mat, args.metadata_csv, args.result_mat, args.model,
            args.imputer, args.scaler, args.expected_csv, greyscale_report=args.greyscale_report,
            use_bn=not args.no_bn, device=args.device,
        )
        out["checks"]["head"] = json.loads(report.to_json())

    demo_flags = {
        "--video": args.video, "--model": args.model, "--imputer": args.imputer,
        "--scaler": args.scaler, "--resnet-weights": args.resnet_weights,
        "--vit-weights": args.vit_weights,
    }
    missing = sorted(k for k, v in demo_flags.items() if not v)
    if missing:
        out["checks"]["demo"] = {"skipped": f"missing {' '.join(missing)}"}
    else:
        out["checks"]["demo"] = demo_parity(
            args.video, args.video_type, args.model, args.imputer, args.scaler,
            args.resnet_weights, args.vit_weights, expected_mos=args.expected_mos, device=args.device,
        )

    out["checks"]["production"] = production_numerics(device=args.device)

    ran = [c for c in out["checks"].values() if "skipped" not in c]
    out["ran"] = len(ran)
    out["ok"] = all(c.get("ok", True) for c in ran)
    return out

"""relaxtpu_torch CLI (counterpart of ``relaxtpu/cli/__main__.py``).

Scoring: ``predict`` (one video; ``--arch fastvqa --weights <state dict>``
scores it with FAST-VQA instead), ``predict-batch`` (many videos, streamed
or batched, grouped by resolution), ``serve`` (JSON lines on stdin) and
``warmup``.  Containers (mp4, mkv, avi, webm) need the native libav
decoder or cv2 on the host; ``--ingest`` picks BGR or I420 upload for
them.  Raw I420 ``.yuv`` files take their geometry as flags.  Example::

    python -m relaxtpu_torch.cli predict --video v.mp4 --model mlp.npz \
        --imputer konvid_1k_imputer.pkl --scaler konvid_1k_scaler.pkl

Extraction: ``extract`` writes a dataset's features into relaxtpu's store
(``<output>/<tag>/video_<i+1>.npy``, ``<output>/<tag>_features.npy``,
``--save-mat``) for the full model (``--mode full``, the 35,203 vector) or
one of the reference's ablation modes, resumes where a store has a video,
and prints one JSON line.  A raw ``.yuv`` dataset takes each video's
``framerate``, ``width`` and ``height`` from its metadata row; a container
is probed for what its row lacks.  Example::

    python -m relaxtpu_torch.cli extract --dataset konvid_1k \
        --metadata-csv meta.csv --root data --mode optical_flow --network vit

Dataset tools (host only, no ``--device``): ``metadata`` (the metadata CSV
from a directory, an info ``.mat`` or a source CSV) and ``greyscale`` (the
report of greyscale videos, read through cv2).

Training: ``train`` (repeated holdout), ``train-lsvq`` (LSVQ fixed split),
``finetune`` (cross-dataset, or ``--zero-shot``) and ``train-cross``, with
the JAX CLI's flags and ``--device``; each prints one JSON result line, as
the JAX CLI does.  Example::

    python -m relaxtpu_torch.cli train --metadata-csv meta.csv \
        --features feats.npy --output mlp.npz --device cpu

Tools: ``visualize`` (the ViT's last-block CLS attention over a frame
pair's motion fragment, as a heatmap over the frame), ``parity`` (the
strict-parity checks of ``relaxtpu_torch.parity``; exit code 1 when a check
that ran fails) and ``report`` (results tables from reference-format
training logs and VSFA ``.npy`` files; host only).

``--config run.json`` (before the subcommand) takes the defaults of every
subcommand from a ``RunConfig`` file (``relaxtpu_torch.config``, the JAX
package's format); explicit flags still win.

Several devices: ``extract`` and ``predict-batch`` take ``--n-data`` and
``--n-model`` and then run one process per rank of the mesh, started with
``torchrun`` (NCCL on CUDA, gloo with ``--device cpu``)::

    torchrun --nproc-per-node 2 -m relaxtpu_torch.cli extract --n-data 2 \
        --dataset konvid_1k --metadata-csv meta.csv --root data
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import contextlib
import csv
import glob
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from relaxtpu_torch.io.video import _clean_meta, decode_video
from relaxtpu_torch.ops.colorspace import bgr_to_yuv420, pack_i420

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


def _geometry(path: str, framerate, width, height, defaults: dict) -> dict:
    """A request's decode geometry: what it gives, and for a raw ``.yuv``
    file the defaults for what it lacks (a container carries its own)."""
    given = dict(framerate=framerate, width=width, height=height)
    if path.endswith(".yuv"):
        given = {k: defaults.get(k) if v is None else v for k, v in given.items()}
    return given


def serve_loop(predictor, requests, out, in_flight: int = 2, defaults: dict | None = None,
               ingest: str = "auto") -> None:
    """The scoring server: JSON-lines requests -> JSON-lines responses.

    A request is a bare path or ``{"video", "framerate", "width",
    "height"}``; a raw ``.yuv`` request takes what it lacks from
    ``defaults``, a container is probed.  ``out`` gets ``{"status":
    "ready"}`` first, then one response a request, in request order:
    ``{"video", "predicted_mos"}`` or ``{"video", "error"}``.  Up to
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
            path = req["video"]
            try:
                geometry = _geometry(path, req.get("framerate"), req.get("width"), req.get("height"), defaults)
                pending.append((path, predictor.enqueue_file(path, **geometry, ingest=ingest), None))
            except Exception as e:  # one bad request must not stop the server
                log.exception("request for %s failed", path)
                pending.append((path, None, str(e)))
        while len(pending) > in_flight:
            emit(*pending.popleft())
    while pending:
        emit(*pending.popleft())


def predict_batch(predictor, paths, decode, batch=1, decode_workers: int = 4,
                  evaluator=None) -> list[tuple[str, float]]:
    """MOS of every video in ``paths`` -> [(path, mos)] in input order.

    ``decode(path)`` gives ``io.video.decode_video``'s ``(kind, data)``;
    host threads run it ahead of the device.  I420-decoded videos are
    grouped by (h, w): with ``batch`` N > 1 each group's runs of N videos go
    through the batched program, with ``batch`` 1 each video through the
    single-video program; ``"auto"`` picks one of the two from a link probe
    at the first I420 video (``utils.linkprobe``).  A BGR-decoded video goes
    through the BGR program (``predict_arrays``' program), on its own.  Two
    programs stay enqueued while later videos decode; a group left short of
    N runs at the end.

    With ``evaluator`` (a ``parallel.eval.ShardedVideoEvaluator``, which
    every rank of its mesh runs with the same videos) each group's runs go
    through its video-sharded batched program, N floored at the data axis
    (fewer videos would leave ranks computing padding).  A BGR video still
    runs on each rank's own device through the BGR program, as the JAX
    CLI runs it on one device.
    """
    extractor = predictor.extractor
    mos = [None] * len(paths)
    pending, groups = collections.deque(), {}  # groups: (h, w) -> [(index, fbuf, nbuf)]

    def drain(limit: int) -> None:
        while len(pending) > limit:
            indices, vecs = pending.popleft()
            for i, v in zip(indices, vecs.cpu()):
                mos[i] = predictor.predict_feature(v)

    def run_group(key) -> None:
        items, (h, w) = groups.pop(key), key
        if evaluator is not None:
            vecs = evaluator.videos_batch_feature_i420([it[1] for it in items], [it[2] for it in items], h, w)
        elif len(items) == 1:
            vecs = extractor.video_feature_async_i420(items[0][1], items[0][2], h, w)[None]
        else:
            vecs = extractor.video_features_batch_i420([it[1] for it in items], [it[2] for it in items], h, w)
        pending.append(([it[0] for it in items], vecs))
        drain(2)

    with cf.ThreadPoolExecutor(max_workers=decode_workers) as pool:
        for i, (kind, data) in enumerate(pool.map(decode, paths)):
            if kind == "bgr":
                pending.append(([i], extractor.video_feature_async(*data)[None]))
                drain(2)
                continue
            fbuf, nbuf, h, w = data
            if batch == "auto":
                from relaxtpu_torch.utils.linkprobe import measure_link, pick_serving_mode

                batch, reason = pick_serving_mode(fbuf.nbytes + nbuf.nbytes,
                                                  measure_link(n_mb=16, reps=1, device=extractor.device))
                log.info("serving mode: %s", reason)
            groups.setdefault((h, w), []).append((i, fbuf, nbuf))
            if len(groups[(h, w)]) >= (batch if evaluator is None else max(batch, evaluator.mesh.shape["data"])):
                run_group((h, w))
        for key in list(groups):
            run_group(key)
        drain(0)
    return list(zip(paths, mos))


CONTAINERS = ("*.mp4", "*.mkv", "*.avi", "*.webm")


def _video_paths(items) -> list[str]:
    """Files as given; a directory gives its containers (each pattern of
    ``CONTAINERS`` sorted, in turn) and then its raw ``.yuv`` files."""
    paths = []
    for v in items:
        if os.path.isdir(v):
            for pattern in (*CONTAINERS, "*.yuv"):
                paths += sorted(glob.glob(os.path.join(v, pattern)))
        else:
            paths.append(v)
    if not paths:
        raise SystemExit("no videos found")
    return paths


def _build_fastvqa(args):
    """FAST-VQA's predictor: ``--weights`` (a ``models.swin3d.FastVQA`` state
    dict, Video Swin and FAST-VQA's names), or seeded random weights."""
    from relaxtpu_torch.device import default_dtype, resolve_device
    from relaxtpu_torch.features.fastvqa import FastVQAExtractor
    from relaxtpu_torch.models.swin3d import random_state
    from relaxtpu_torch.predict import FastVQAPredictor

    device = resolve_device(args.device)
    if args.weights:
        state = torch.load(args.weights, map_location="cpu", weights_only=True)
        state = state.get("state_dict", state)
    else:
        logging.warning("no weights given: using seeded random FAST-VQA weights")
        state = random_state(0)
    return FastVQAPredictor(FastVQAExtractor(state, default_dtype(device, args.bf16), device))


def cmd_predict(args):
    if args.arch == "fastvqa":
        score = _build_fastvqa(args).predict_file(args.video, framerate=args.framerate, width=args.width,
                                                  height=args.height)
        print(json.dumps({"video": args.video, "predicted_score": score}))
        return
    missing = [f"--{k}" for k in ("model", "imputer", "scaler") if getattr(args, k) is None]
    if missing:
        raise SystemExit(f"predict --arch relaxvqa needs {', '.join(missing)}")
    predictor = _load_predictor(args, _build_extractor(args))
    mos = predictor.predict_file(args.video, framerate=args.framerate, width=args.width,
                                 height=args.height, ingest=args.ingest)
    print(json.dumps({"video": args.video, "predicted_mos": mos}))


def _mesh_for(args):
    """The mesh of ``--n-data``/``--n-model``, None for one device.  Above
    one rank the process group comes from torchrun's environment (or is
    already initialised); without either the command raises, rather than
    run on one device."""
    if (args.n_data or 1) * args.n_model <= 1:
        return None
    from relaxtpu_torch.parallel.distributed import initialize, launched
    from relaxtpu_torch.parallel.mesh import make_mesh

    if not torch.distributed.is_initialized() and not launched():
        raise RuntimeError(f"--n-data {args.n_data} --n-model {args.n_model}: a mesh runs one process a "
                           "rank; start it with torchrun --nproc-per-node N -m relaxtpu_torch.cli ...")
    mesh = make_mesh(args.n_data, args.n_model, initialize(device=args.device))
    log.info("mesh %s: rank %d at data %d, model %d on %s", mesh.shape, mesh.rank, mesh.data_index,
             mesh.model_index, mesh.device)
    return mesh


def cmd_predict_batch(args):
    paths = _video_paths(args.videos)
    mesh = _mesh_for(args)
    predictor = _load_predictor(args, _build_extractor(args))
    flags = dict(framerate=args.framerate, width=args.width, height=args.height)

    def decode(path):
        return decode_video(path, **_geometry(path, None, None, None, flags), ingest=args.ingest)

    evaluator = None
    if mesh is not None:
        from relaxtpu_torch.parallel.eval import ShardedVideoEvaluator

        evaluator = ShardedVideoEvaluator(predictor.extractor, mesh, decode_workers=args.decode_workers)
    rows = predict_batch(predictor, paths, decode, batch=args.batch, decode_workers=args.decode_workers,
                         evaluator=evaluator)
    if mesh is not None and mesh.rank != 0:
        return
    for path, mos in rows:
        print(json.dumps({"video": path, "predicted_mos": mos}))
    if args.output_csv:
        with open(args.output_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["video", "predicted_mos"])
            writer.writerows(rows)


def warm_programs(extractor, resolutions, counts, ingest: str = "auto"):
    """Run each video program once for every resolution ("HxW") and count
    (c frames and c pairs of seeded random frames), fetching the vector;
    yields one record each, as the JAX package's warm-up does, with
    ``compile_s`` the seconds of that first call.  Eager PyTorch compiles
    no program: the first calls build and load the kernel library, fill the
    resize-matrix cache for the resolution and warm cuDNN and cuBLAS.  I420
    ingest runs for ``yuv`` and ``auto`` at even dimensions, BGR for ``bgr``
    and ``auto``."""
    for res in resolutions:
        h, w = (int(v) for v in res.lower().split("x"))
        rng = np.random.default_rng(0)
        for c in sorted({int(c) for c in counts}):
            frames = rng.integers(0, 256, (c, h, w, 3), dtype=np.uint8)
            nxt = rng.integers(0, 256, (c, h, w, 3), dtype=np.uint8)
            t0 = time.perf_counter()
            if ingest in ("yuv", "auto") and h % 2 == 0 and w % 2 == 0:
                fbuf, nbuf = pack_i420(*bgr_to_yuv420(frames)), pack_i420(*bgr_to_yuv420(nxt))
                extractor.video_feature_async_i420(fbuf, nbuf, h, w).cpu()
            if ingest in ("bgr", "auto"):
                extractor.video_feature_async(frames, frames, nxt).cpu()
            yield {"resolution": res, "frames": c, "pairs": c, "bucket": 1,
                   "compile_s": round(time.perf_counter() - t0, 3)}


def cmd_warmup(args):
    for rec in warm_programs(_build_extractor(args), args.resolutions, args.counts, args.ingest):
        print(json.dumps(rec))


def cmd_serve(args):
    predictor = _load_predictor(args, _build_extractor(args))
    for rec in warm_programs(predictor.extractor, args.warm or (), args.warm_counts, args.ingest):
        log.info("warmed %s", rec)
    serve_loop(predictor, sys.stdin, sys.stdout, args.in_flight,
               dict(framerate=args.framerate, width=args.width, height=args.height), args.ingest)


def _single_layer_frames(ablation, network: str, layer: str, frames: torch.Tensor) -> torch.Tensor:
    """Full-frame single-tap features (the reference's ``main_layer.py``):
    the ablation's feature step on the frames themselves, not quantised."""
    return ablation.features_from_images(network, layer, frames)


def _extract_one(extractor, ablation, mode: str, network: str, layer: str, kind: str, data) -> torch.Tensor:
    """One video's stored features for ``mode``, on the device, not fetched.

    ``kind, data``: ``io.video.decode_video``'s result, I420 stacks or BGR
    frames.  ``full``: the (35203,) vector of the single-video program,
    enqueued without waiting.  Else the per-frame or per-pair matrix of the
    reference's ablation scripts; only the networks whose output is stored
    run.  ``layer_stack`` and ``layer`` with ``vit``: the frames' ViT stats;
    ``layer_stack``: the frames' ResNet layer stack; ``layer`` with
    ``resnet50``: the single tap ``layer``; ``fragment_layerstack`` /
    ``fragment_pool``: frag_resnet / frag_vit of the pairs; the residual
    modes: ``network``'s tap of each pair's residual image, a chunk of
    ``max_pair_batch`` pairs at a time.
    """
    if mode == "full":
        if kind == "i420":
            return extractor.video_feature_async_i420(*data)
        return extractor.video_feature_async(*data)
    if mode in ("layer_stack", "layer"):  # the frames alone
        if kind == "i420":  # no successor frames go up
            fbuf, nbuf, h, w = data
            frames, _ = extractor._i420_inputs([fbuf], [nbuf[:0]], h, w)
        else:
            frames = extractor.upload([data[0]])
        if network == "vit":
            return extractor.frame_features_dev(frames, ("vit",))[1]
        if mode == "layer_stack":
            return extractor.frame_features_dev(frames, ("resnet50",))[0]
        return _single_layer_frames(ablation, network, layer, frames)
    if kind == "i420":  # the pairs alone
        fbuf, nbuf, h, w = data
        prev, nxt = extractor._i420_inputs([fbuf], [nbuf], h, w)[1](0, len(nbuf))
    else:
        _, prev, nxt = extractor.upload_bgr(*data)
    if mode == "fragment_layerstack":
        return extractor.pair_features_dev(prev, nxt, ("resnet50",))[0]
    if mode == "fragment_pool":
        return extractor.pair_features_dev(prev, nxt, ("vit",))[1]
    from relaxtpu_torch.features.pipeline import pair_chunks

    chunks = pair_chunks(len(prev), extractor.max_pair_batch(prev.shape[1], prev.shape[2]))
    return torch.cat([ablation.pair_features_dev(mode, network, layer, prev[s:e], nxt[s:e]) for s, e in chunks])


def _row_geometry(meta: dict, i: int) -> tuple:
    """framerate, width and height of row ``i`` of the metadata, None where
    the row or the metadata has none (``io.video`` requires them of a raw
    .yuv file and probes a container for them)."""
    out = []
    for col, cast in (("framerate", float), ("width", int), ("height", int)):
        value = _clean_meta(meta[col][i]) if col in meta else None
        out.append(None if value is None else cast(float(value)))
    return tuple(out)


def cmd_extract(args):
    from relaxtpu_torch.device import resolve_device

    resolve_device(args.device)
    mesh = _mesh_for(args)
    if mesh is None:
        _extract(args)
    elif args.mode == "full":
        _extract_sharded(args, mesh)
    else:  # as the JAX CLI, the mode runs on one device: rank 0's
        logging.warning("--n-data/--n-model: mesh extraction supports --mode full only; rank 0 runs "
                        "mode=%s on one device and the other ranks end at once", args.mode)
        # no collective: a wait of the other ranks would time out with the
        # group (distributed.TIMEOUT) while rank 0 runs a whole dataset
        if mesh.rank == 0:
            _extract(args)


def _extract_setup(args):
    """The dataset, its metadata, the store and its tag, and ``decode(i)``
    of the dataset's video i (``io.video.decode_video``'s result)."""
    from relaxtpu_torch.data.store import FeatureStore
    from relaxtpu_torch.io.datasets import data_root, get_dataset, load_metadata, read_metadata_csv

    spec = get_dataset(args.dataset)
    root = data_root(args.root)
    meta = read_metadata_csv(args.metadata_csv) if args.metadata_csv else load_metadata(spec, args.metadata_dir)
    # the tag ignores --network and --layer, as relaxtpu's store layout does
    tag = args.dataset if args.mode == "full" else f"{args.dataset}_{args.mode}"
    # the ablation modes decode BGR, as the JAX CLI's do
    ingest = args.ingest if args.mode == "full" else "bgr"

    def decode(i: int):
        path = spec.video_path(root, str(meta["vid"][i]))
        return decode_video(path, *_row_geometry(meta, i), ingest=ingest)

    return len(meta["vid"]), FeatureStore(args.output), tag, decode


def _extract_finish(args, store, tag: str, n: int, **extra) -> None:
    """The dataset's matrix (``<output>/<tag>_features.npy``, ``--save-mat``)
    and the JSON line."""
    mat = store.assemble(tag, n)
    np.save(os.path.join(args.output, f"{tag}_features.npy"), mat)
    if args.save_mat:
        store.save_mat(tag, n, args.save_mat, key=args.dataset)
    print(json.dumps({"dataset": args.dataset, "mode": args.mode, "shape": list(mat.shape), **extra}))


def _extract(args) -> None:
    """Extraction on one device."""
    from relaxtpu_torch.features.ablation import AblationExtractor
    from relaxtpu_torch.utils.profiling import trace_to

    n, store, tag, decode = _extract_setup(args)
    extractor = _build_extractor(args)
    ablation = AblationExtractor(extractor)
    todo = [i for i in range(n) if not store.has(tag, i)]
    # full: up to --dispatch-ahead vectors stay enqueued on the device while
    # later videos decode; the ablation modes store each video at once
    ahead = args.dispatch_ahead if args.mode == "full" else 0
    pending = collections.deque()  # (index, features on the device)

    def drain(limit: int) -> None:
        while len(pending) > limit:
            j, feat = pending.popleft()
            store.put(tag, j, feat.cpu().numpy())
            log.info("extracted video %d of %d", j + 1, n)

    def extract(i: int, decoded) -> None:
        pending.append((i, _extract_one(extractor, ablation, args.mode, args.network, args.layer,
                                        *decoded.result())))
        drain(ahead)

    profile = trace_to(args.profile_dir, extractor.device) if args.profile_dir else contextlib.nullcontext()
    with profile, cf.ThreadPoolExecutor(max_workers=args.decode_workers) as pool:
        decoding = collections.deque()  # at most decode_workers + 1 decoded videos wait
        for i in todo:
            decoding.append((i, pool.submit(decode, i)))
            if len(decoding) > args.decode_workers:
                extract(*decoding.popleft())
        while decoding:
            extract(*decoding.popleft())
        drain(0)
    _extract_finish(args, store, tag, n)


def _extract_sharded(args, mesh) -> None:
    """``--mode full`` over a mesh of ranks: after a barrier every rank reads
    the store (the same videos to do on every rank), decodes and computes
    its data index's round-robin share through
    ``ShardedVideoEvaluator.run``, and gets every row; rank 0 alone writes
    the store, the matrix and the JSON line, and the ranks end together."""
    from relaxtpu_torch.parallel.eval import ShardedVideoEvaluator
    from relaxtpu_torch.utils.profiling import trace_to

    n, store, tag, decode = _extract_setup(args)
    extractor = _build_extractor(args)

    def decode_for_run(i: int):  # the evaluator's forms: BGR arrays or ("i420", ...)
        kind, data = decode(i)
        return ("i420", *data) if kind == "i420" else data

    torch.distributed.barrier()
    todo = [i for i in range(n) if not store.has(tag, i)]
    evaluator = ShardedVideoEvaluator(extractor, mesh, decode_workers=args.decode_workers)
    profile = trace_to(args.profile_dir, extractor.device) if args.profile_dir else contextlib.nullcontext()
    with profile:
        vecs = evaluator.run(todo, decode_for_run,
                             on_result=lambda k, _: log.info("extracted video %d of %d", todo[k] + 1, n))
    if mesh.rank == 0:
        for i, vec in zip(todo, vecs):
            store.put(tag, i, vec)
        _extract_finish(args, store, tag, n, mesh=mesh.shape)
    torch.distributed.barrier()


def cmd_metadata(args):
    """The dataset metadata CSV: an info ``.mat``, a source CSV, or a scan
    of ``--video-dir``."""
    from relaxtpu_torch.io.metadata import extract_metadata, metadata_from_csv, metadata_from_info_mat, write_csv

    if args.info_mat:
        columns, rows = metadata_from_info_mat(args.info_mat, args.video_dir, video_type=args.video_type,
                                               framerate_hint=args.framerate)
    elif args.csv:
        columns, rows = metadata_from_csv(args.csv, args.video_dir, video_type=args.video_type)
    else:
        columns, rows = extract_metadata(args.video_dir)
    write_csv(args.output, columns, rows)
    print(json.dumps({"output": args.output, "n_videos": len(rows)}))


def cmd_greyscale(args):
    """The greyscale-video report of a dataset (the reference's
    ``check_greyscale.py``), read through cv2."""
    from relaxtpu_torch.data.greyscale import greyscale_report, write_report
    from relaxtpu_torch.io.datasets import data_root, get_dataset, load_metadata, read_metadata_csv

    spec = get_dataset(args.dataset)
    meta = read_metadata_csv(args.metadata_csv) if args.metadata_csv else load_metadata(spec, args.metadata_dir)
    root = data_root(args.root)
    rows = greyscale_report(meta, lambda vid: spec.video_path(root, str(vid)), progress=log.info)
    out = args.output or os.path.join(args.metadata_dir, "greyscale_report",
                                      f"{args.dataset.upper()}_greyscale_metadata.csv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_report(out, rows)
    print(json.dumps({"output": out, "n_greyscale": len(rows)}))


def _grey_indices_for(args, dataset: str):
    """Greyscale rows to drop: an explicit report, else the conventional
    location for youtube_ugc (the only dataset the reference drops them for)."""
    from relaxtpu_torch.data.greyscale import load_grey_indices

    report = getattr(args, "greyscale_report", None)
    if report is None and dataset == "youtube_ugc":
        report = os.path.join(args.metadata_dir, "greyscale_report",
                              f"{dataset.upper()}_greyscale_metadata.csv")
        if not os.path.exists(report):
            log.warning("youtube_ugc: no greyscale report at %s; greyscale videos "
                        "will NOT be dropped", report)
            return None
    return load_grey_indices(report) if report else None


def _load_features(paths: list[str], key: str):
    from relaxtpu_torch.data.store import load_chunked_features, load_mat_features

    if len(paths) == 1 and paths[0].endswith(".npy"):
        return np.load(paths[0])
    if len(paths) == 1:
        return load_mat_features(paths[0], key)
    return load_chunked_features(paths, key)


def _median(results, key: str) -> float:
    return float(np.median([getattr(r, key) for r in results]))


def cmd_train(args):
    from relaxtpu_torch.device import resolve_device
    from relaxtpu_torch.io.datasets import read_metadata_csv
    from relaxtpu_torch.model.protocol import run_repeated_holdout
    from relaxtpu_torch.model.train import TrainConfig
    from relaxtpu_torch.utils.checkpoint import save_snapshot

    device = resolve_device(args.device)
    meta = read_metadata_csv(args.metadata_csv)
    features = np.load(args.features)
    cfg = TrainConfig(
        n_repeats=args.n_repeats, n_splits=args.n_splits, batch_size=args.batch_size,
        epochs=args.epochs, initial_lr=args.lr, weight_decay=args.weight_decay,
        select_criteria=args.select_criteria, use_bn=not args.no_bn, kfold=not args.no_kfold,
    )
    grey = _grey_indices_for(args, args.dataset)
    if grey:
        log.info("dropping %d greyscale videos", len(grey))
    progress = print
    if args.artifacts_dir:
        # the reference's run log: hyperparameters and per-repeat results
        from relaxtpu_torch.utils.logging import setup_logger

        os.makedirs(args.artifacts_dir, exist_ok=True)
        run_log = setup_logger("relaxtpu_torch.train", os.path.join(args.artifacts_dir, "train.log"))
        run_log.info("config: %s", cfg)

        def progress(msg):  # noqa: F811 -- to stdout and the run log
            print(msg)
            run_log.info(msg)

    median, _, results = run_repeated_holdout(
        meta, features, cfg, grey_indices=grey, progress=progress,
        resume_dir=args.resume_dir, device=device, artifacts_dir=args.artifacts_dir,
    )
    save_snapshot(args.output, median.snapshot)
    print(json.dumps({
        "median_srcc": _median(results, "srcc"), "median_krcc": _median(results, "krcc"),
        "median_plcc": _median(results, "plcc"), "median_rmse": _median(results, "rmse"),
        "model": args.output,
    }))


def cmd_train_lsvq(args):
    """LSVQ fixed split: k-fold off, no BN (the reference's 'simple' head)."""
    from relaxtpu_torch.data.splits import split_lsvq
    from relaxtpu_torch.device import resolve_device
    from relaxtpu_torch.io.datasets import read_metadata_csv
    from relaxtpu_torch.model.protocol import run_fixed_split
    from relaxtpu_torch.model.train import TrainConfig
    from relaxtpu_torch.utils.checkpoint import save_snapshot

    device = resolve_device(args.device)
    x_tr, y_tr, x_te, y_te, _ = split_lsvq(
        read_metadata_csv(args.train_metadata), read_metadata_csv(args.test_metadata),
        _load_features(args.train_features, args.train_key),
        _load_features(args.test_features, args.test_key),
    )
    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, initial_lr=args.lr,
        weight_decay=args.weight_decay, select_criteria=args.select_criteria,
        use_bn=False, kfold=False,
    )
    result, _ = run_fixed_split(x_tr, y_tr, x_te, y_te, cfg, progress=print, device=device)
    save_snapshot(args.output, result.snapshot)
    print(json.dumps({"srcc": result.srcc, "krcc": result.krcc, "plcc": result.plcc,
                      "rmse": result.rmse, "model": args.output}))


def cmd_finetune(args):
    from relaxtpu_torch.device import resolve_device
    from relaxtpu_torch.io.datasets import read_metadata_csv
    from relaxtpu_torch.model.protocol import FineTuneConfig, fine_tune, zero_shot_eval
    from relaxtpu_torch.model.train import MlpTrainer, TrainConfig
    from relaxtpu_torch.utils.checkpoint import load_snapshot, save_snapshot

    device = resolve_device(args.device)
    y = read_metadata_csv(args.metadata_csv)["mos"]
    features = np.load(args.features)
    base = load_snapshot(args.base_model)
    trainer = MlpTrainer(TrainConfig(use_bn=not args.no_bn), features.shape[1], device)
    ft = FineTuneConfig(n_repeats=args.n_repeats, epochs=args.epochs)
    mos_is_1_5 = args.dataset in ("konvid_1k", "youtube_ugc")
    if args.zero_shot:
        _, results = zero_shot_eval(base, trainer, features, y, ft, mos_is_1_5=mos_is_1_5, progress=print)
        print(json.dumps({"median_srcc": _median(results, "srcc"),
                          "median_rmse": _median(results, "rmse"), "zero_shot": True}))
        return
    median, results = fine_tune(base, trainer, features, y, ft, mos_is_1_5=mos_is_1_5, progress=print)
    save_snapshot(args.output, median.snapshot)
    print(json.dumps({"median_srcc": _median(results, "srcc"),
                      "median_rmse": _median(results, "rmse"), "model": args.output}))


def cmd_train_cross(args):
    """Train on one dataset, test on another."""
    from relaxtpu_torch.data.splits import split_cross_dataset
    from relaxtpu_torch.device import resolve_device
    from relaxtpu_torch.io.datasets import read_metadata_csv
    from relaxtpu_torch.model.protocol import run_fixed_split
    from relaxtpu_torch.model.train import TrainConfig
    from relaxtpu_torch.utils.checkpoint import save_snapshot

    device = resolve_device(args.device)
    x_tr, y_tr, x_te, y_te, _ = split_cross_dataset(
        read_metadata_csv(args.train_metadata), read_metadata_csv(args.test_metadata),
        np.load(args.train_features), np.load(args.test_features),
        train_name=args.train_dataset, test_name=args.test_dataset,
    )
    cfg = TrainConfig(use_bn=not args.no_bn, epochs=args.epochs)
    result, _ = run_fixed_split(x_tr, y_tr, x_te, y_te, cfg, progress=print, device=device)
    save_snapshot(args.output, result.snapshot)
    print(json.dumps({"srcc": result.srcc, "plcc": result.plcc, "rmse": result.rmse}))


def cmd_report(args):
    """Cross-method results table from reference-format training logs and
    VSFA ``.npy`` results, optionally beside the reference's published
    numbers; printed fixed-width, and written as pandas would write it."""
    from relaxtpu_torch.utils.report import (
        REFERENCE_INTRA_DATASET,
        against_baseline,
        competitor_table,
        format_table,
        parse_vsfa_npy,
        write_table_csv,
    )

    log_paths: dict = {}
    for spec in args.log:
        try:
            method, ds, path = spec.split("=", 2)
        except ValueError:
            raise SystemExit(f"--log wants METHOD=DATASET=PATH, got: {spec}")
        log_paths.setdefault(method, {})[ds] = path
    rows = competitor_table(log_paths) if log_paths else []
    for spec in args.vsfa_npy:
        try:
            ds, path = spec.split("=", 1)
        except ValueError:
            raise SystemExit(f"--vsfa-npy wants DATASET=PATH, got: {spec}")
        rows.append({"method": "VSFA", "dataset": ds,
                     **{k: v for k, v in parse_vsfa_npy(path).items() if k != "n_test"}})
    if args.with_baseline:
        rows = against_baseline(rows, REFERENCE_INTRA_DATASET)
    if not rows:
        raise SystemExit("nothing to report: pass --log/--vsfa-npy/--with-baseline")
    print(format_table(rows))
    if args.output_csv:
        write_table_csv(args.output_csv, rows)


def cmd_visualize(args):
    """Fragment attention overlay: the residual's fragment positions, the
    original frame's fragment through the ViT on the device, the head-mean
    CLS attention of its last block mapped onto the frame."""
    import cv2

    from relaxtpu_torch.ops.fragments import fragment_pair
    from relaxtpu_torch.visualize import (
        cls_patch_attention,
        fragment_positions,
        last_selfattention,
        map_attention_to_original,
    )

    extractor = _build_extractor(args)
    prev = cv2.imread(args.frame)
    nxt = cv2.imread(args.next_frame)
    for path, img in ((args.frame, prev), (args.next_frame, nxt)):
        if img is None:
            raise SystemExit(f"could not read image: {path}")
    residual = np.abs(prev.astype(np.int32) - nxt.astype(np.int32)).astype(np.uint8)
    dev = extractor.device
    _, ori_frag = fragment_pair(torch.from_numpy(residual)[None].to(dev), torch.from_numpy(prev)[None].to(dev))
    positions = fragment_positions(residual, device=dev)
    attn = last_selfattention(extractor.vit, ori_frag[0].cpu().numpy()[..., ::-1] / 255.0)
    overlay = map_attention_to_original(prev, cls_patch_attention(attn).reshape(-1), positions)
    out = args.output
    if not os.path.splitext(out)[1]:  # a bare name or a directory: a PNG inside it
        out = os.path.join(out, "attention_overlay.png")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if not cv2.imwrite(out, overlay):
        raise SystemExit(f"could not write overlay image: {out}")
    print(json.dumps({"overlay": out, "n_patches": len(positions)}))


def cmd_parity(args):
    """The strict-parity checks (``relaxtpu_torch.parity``); 0 when the
    check passes, else 1."""
    from relaxtpu_torch import parity

    if args.check in ("head", "demo") and not (args.model and args.imputer and args.scaler):
        raise SystemExit("--model/--imputer/--scaler are required for this check")
    if args.check == "all":
        out = parity.all_parity(args)
        print(json.dumps(out, indent=2))
        return 0 if out["ok"] else 1
    if args.check == "production":
        out = parity.production_numerics(device=args.device)
        print(json.dumps(out, indent=2))
        return 0 if out.get("ok", True) else 1
    if args.check == "head":
        report = parity.head_parity(
            args.dataset, args.features_mat, args.metadata_csv, args.result_mat, args.model,
            args.imputer, args.scaler, args.expected_csv, greyscale_report=args.greyscale_report,
            use_bn=not args.no_bn, device=args.device,
        )
        print(report.to_json())
        return 0 if report.ok else 1
    if args.check == "features":
        out = parity.feature_parity(args.video, args.resnet_weights, args.vit_weights, device=args.device)
        print(json.dumps(out, indent=2))
        return 0 if out["ok"] else 1
    out = parity.demo_parity(
        args.video, args.video_type, args.model, args.imputer, args.scaler,
        args.resnet_weights, args.vit_weights, expected_mos=args.expected_mos, device=args.device,
    )
    print(json.dumps(out))
    return 0 if out.get("ok", True) else 1


def _add_model_flags(sp, required: bool = True) -> None:
    sp.add_argument("--video-type", default="konvid_1k")
    sp.add_argument("--model", required=required, help=".npz snapshot or reference .pth")
    sp.add_argument("--imputer", required=required)
    sp.add_argument("--scaler", required=required)
    sp.add_argument("--finetuned", action="store_true")
    _add_backbone_flags(sp)


def _add_backbone_flags(sp) -> None:
    sp.add_argument("--resnet-weights", default=None, help="torchvision resnet50 .pth")
    sp.add_argument("--vit-weights", default=None, help="DINO ViT-B/16 .pth")
    grp = sp.add_mutually_exclusive_group()
    grp.add_argument("--bf16", dest="bf16", action="store_true", default=None,
                     help="bfloat16 backbones (the default on CUDA)")
    grp.add_argument("--f32", dest="bf16", action="store_false",
                     help="float32 backbones with TF32 off (strict-parity mode)")
    _add_device_flag(sp)


def _add_mesh_flags(sp, what: str) -> None:
    sp.add_argument("--n-data", type=int, default=None,
                    help=f"ranks on the mesh's data axis (default: the world over --n-model); above one "
                    f"rank, one process a rank started with torchrun: {what}")
    sp.add_argument("--n-model", type=int, default=1,
                    help="ranks on the mesh's model axis, which compute the same videos")


def _add_device_flag(sp) -> None:
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_geometry_flags(sp, what: str) -> None:
    sp.add_argument("--framerate", type=float, default=None, help=f"frame rate of {what}")
    sp.add_argument("--width", type=int, default=None, help=f"width of {what}")
    sp.add_argument("--height", type=int, default=None, help=f"height of {what}")


def _add_ingest_flag(sp) -> None:
    sp.add_argument("--ingest", default="auto", choices=["bgr", "yuv", "auto"],
                    help="containers: auto (default) uploads the decoder's I420 (1.5 bytes a "
                    "pixel, converted on the device) where the native decoder gives it, else BGR; "
                    "yuv: I420 or an error; bgr: BGR converted on the host.  A raw .yuv file "
                    "gives the JAX package's frames in every mode")


def build_parser() -> tuple[argparse.ArgumentParser, dict]:
    """(parser, {subcommand: subparser})."""
    p = argparse.ArgumentParser(prog="relaxtpu_torch")
    p.add_argument("--config", default=None,
                   help="RunConfig JSON (relaxtpu_torch.config): defaults for every subcommand's flags")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("predict", help="one video -> MOS (ReLaX-VQA) or quality score (FAST-VQA)")
    sp.add_argument("--video", required=True)
    sp.add_argument("--arch", default="relaxvqa", choices=["relaxvqa", "fastvqa"],
                    help="relaxvqa (default: --model, --imputer and --scaler) or fastvqa (FAST-B: --weights)")
    sp.add_argument("--weights", default=None,
                    help="fastvqa: a FastVQA state dict (.pth; seeded random weights without it)")
    _add_model_flags(sp, required=False)
    _add_geometry_flags(sp, "a raw .yuv video (a container carries its own)")
    _add_ingest_flag(sp)
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser(
        "predict-batch", help="MOS for many videos, streamed or batched",
        description="A directory gives its *.mp4, *.mkv, *.avi and *.webm files, then its raw "
        "*.yuv files, which take --framerate, --width and --height.  I420-decoded videos are "
        "grouped by resolution into batched or streamed runs; BGR-decoded ones run one by one.",
    )
    sp.add_argument("--videos", nargs="+", required=True, help="video files and/or directories")
    _add_model_flags(sp)
    _add_geometry_flags(sp, "every raw .yuv video")
    _add_ingest_flag(sp)
    sp.add_argument("--batch", type=lambda v: v if v == "auto" else int(v), default=1,
                    help="videos a device program: 1 (default) streams each video through "
                    "the single-video program, N > 1 sends runs of N videos of one resolution "
                    "through the batched program (either way 2 programs stay enqueued); "
                    "'auto' probes the host-to-device link and picks one of the two")
    sp.add_argument("--decode-workers", type=int, default=4, help="host decode threads")
    sp.add_argument("--output-csv", default=None, help="also write a video,predicted_mos CSV")
    _add_mesh_flags(sp, "each resolution's runs of videos (at least --n-data) split over the ranks; "
                    "rank 0 prints the rows and writes the CSV")
    sp.set_defaults(fn=cmd_predict_batch)

    sp = sub.add_parser(
        "serve", help="scoring server: JSON-lines requests on stdin -> JSON lines on stdout",
        description="A request is a bare path or {\"video\", \"framerate\", \"width\", "
        "\"height\"}; the geometry flags fill what a raw .yuv request lacks.",
    )
    _add_model_flags(sp)
    _add_geometry_flags(sp, "raw .yuv requests that do not give it")
    _add_ingest_flag(sp)
    sp.add_argument("--in-flight", type=int, default=2,
                    help="videos left enqueued on the device while later requests decode")
    sp.add_argument("--warm", nargs="*", default=None, metavar="HxW",
                    help="resolutions to run each program at once before serving, e.g. 540x960 "
                    "(see warmup)")
    sp.add_argument("--warm-counts", nargs="*", type=int, default=(8, 16, 32),
                    help="frame and pair counts to warm at each --warm resolution")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "warmup", help="run each video program once per resolution and count",
        description="Eager PyTorch compiles no program: the first calls build and load the CUDA "
        "kernel library, fill the resize-matrix cache of each resolution and warm cuDNN and "
        "cuBLAS, which is what this does ahead of the first video.  One JSON record a resolution "
        "and count; compile_s is the seconds of that first call.",
    )
    sp.add_argument("--resolutions", nargs="+", default=["540x960", "1080x1920"],
                    help="HxW list, e.g. 540x960 720x1280")
    sp.add_argument("--bucket", type=int, default=8,
                    help="the JAX package's frame-count bucket, accepted and ignored: the port runs "
                    "each video at its own counts and pads nothing")
    sp.add_argument("--counts", nargs="+", type=int, default=[8, 16, 32],
                    help="frame and pair counts to run at each resolution")
    _add_ingest_flag(sp)
    _add_backbone_flags(sp)
    sp.set_defaults(fn=cmd_warmup)

    sp = sub.add_parser(
        "extract", help="a dataset's features into relaxtpu's per-video store",
        description="A raw .yuv dataset takes each video's framerate, width and height from its "
        "metadata row; a container is probed for what its row lacks.",
    )
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--root", default=None, help="data root (default: $RELAXTPU_DATA_ROOT or .)")
    sp.add_argument("--metadata-dir", default="metadata")
    sp.add_argument("--metadata-csv", default=None, help="metadata CSV in place of the registry's")
    sp.add_argument("--output", default="features_out")
    sp.add_argument(
        "--mode", default="full",
        choices=[
            "full",                 # the 35,203 model features (demo_test.py)
            "layer_stack",          # full frames, multi-tap (main_layer_stack.py)
            "layer",                # full frames, single tap (main_layer.py)
            "fragment_layerstack",  # ori + merged fragments, ResNet (main_fragment_layerstack.py)
            "fragment_pool",        # ori + merged fragments, ViT (main_fragment_pool.py)
            "frame_diff",           # whole residual (main_residual.py)
            "optical_flow",         # whole flow image (main_residual.py, flow)
            "frame_diff_frag",      # residual fragment (main_residual_fragment.py)
            "optical_flow_frag",    # flow fragment (main_residual_fragment.py, flow)
        ],
    )
    sp.add_argument("--network", default="resnet50", choices=["resnet50", "vit"])
    sp.add_argument("--layer", default="pool", choices=["pool", "last_layer", "layer_stack"])
    sp.add_argument("--save-mat", default=None, help="also export the reference-format .mat")
    sp.add_argument("--decode-workers", type=int, default=4, help="host decode threads")
    sp.add_argument("--dispatch-ahead", type=int, default=2,
                    help="--mode full: videos left enqueued on the device while later ones decode")
    sp.add_argument("--profile-dir", default=None, help="write a torch.profiler Chrome trace here")
    sp.add_argument("--ingest", default="auto", choices=["bgr", "yuv", "auto"],
                    help="--mode full on containers: auto (default) uploads the decoder's I420 "
                    "where it gives it (the metadata's geometry must be the stream's), else BGR; "
                    "the ablation modes decode BGR")
    _add_mesh_flags(sp, "--mode full: each rank decodes and computes its round-robin share of the "
                    "videos, and rank 0 writes the store; another mode runs on rank 0 alone")
    _add_backbone_flags(sp)
    sp.set_defaults(fn=cmd_extract)

    sp = sub.add_parser("metadata", help="a dataset's metadata CSV (host only)")
    sp.add_argument("--video-dir", required=True)
    sp.add_argument("--output", default="metadata.csv")
    sp.add_argument("--video-type", default="generic",
                    choices=["generic", "lsvq", "live_vqc", "cvd_2014", "live_qualcomm"])
    sp.add_argument("--info-mat", default=None, help="CVD2014/LIVE-Qualcomm info .mat")
    sp.add_argument("--csv", default=None, help="LSVQ/LIVE-VQC source csv")
    sp.add_argument("--framerate", type=float, default=None, help=".yuv framerate hint")
    sp.set_defaults(fn=cmd_metadata)

    sp = sub.add_parser("greyscale", help="a dataset's greyscale-video report (host only, cv2)")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--root", default=None, help="data root (default: $RELAXTPU_DATA_ROOT or .)")
    sp.add_argument("--metadata-dir", default="metadata")
    sp.add_argument("--metadata-csv", default=None)
    sp.add_argument("--output", default=None)
    sp.set_defaults(fn=cmd_greyscale)

    sp = sub.add_parser("train", help="repeated-holdout training of the MLP head")
    sp.add_argument("--dataset", default="konvid_1k")
    sp.add_argument("--metadata-csv", required=True)
    sp.add_argument("--metadata-dir", default="metadata")
    sp.add_argument("--features", required=True, help=".npy (n_videos, 35203)")
    sp.add_argument("--output", default="model/mlp.npz")
    sp.add_argument("--n-repeats", type=int, default=21)
    sp.add_argument("--n-splits", type=int, default=10)
    sp.add_argument("--batch-size", type=int, default=256)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--lr", type=float, default=0.1)
    sp.add_argument("--weight-decay", type=float, default=0.005)
    sp.add_argument("--select-criteria", default="byrmse")
    sp.add_argument("--no-bn", action="store_true")
    sp.add_argument("--no-kfold", action="store_true")
    sp.add_argument("--greyscale-report", default=None,
                    help="greyscale report csv (auto-located for youtube_ugc)")
    sp.add_argument("--resume-dir", default=None, help="per-repeat checkpoint dir")
    sp.add_argument("--artifacts-dir", default=None,
                    help="write the run's artifacts here: train.log (hyperparameters and per-repeat "
                    "results), per-repeat loss curves, the median repeat's logistic-fit scatter")
    _add_device_flag(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("train-lsvq", help="LSVQ fixed-split training (k-fold off, no BN)")
    sp.add_argument("--train-metadata", required=True)
    sp.add_argument("--test-metadata", required=True)
    sp.add_argument("--train-features", nargs="+", required=True,
                    help=".npy or chunked .mat files (the reference ships 3 LSVQ chunks)")
    sp.add_argument("--test-features", nargs="+", required=True)
    sp.add_argument("--train-key", default="lsvq_train")
    sp.add_argument("--test-key", default="lsvq_test")
    sp.add_argument("--output", default="model/mlp_lsvq.npz")
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--batch-size", type=int, default=256)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--weight-decay", type=float, default=5e-4)
    sp.add_argument("--select-criteria", default="bykrcc")
    _add_device_flag(sp)
    sp.set_defaults(fn=cmd_train_lsvq)

    sp = sub.add_parser("finetune", help="cross-dataset fine-tuning of a trained head")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--metadata-csv", required=True)
    sp.add_argument("--features", required=True)
    sp.add_argument("--base-model", required=True)
    sp.add_argument("--output", default="model/mlp_ft.npz")
    sp.add_argument("--n-repeats", type=int, default=21)
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--no-bn", action="store_true")
    sp.add_argument("--zero-shot", action="store_true",
                    help="score the base model on the target's test splits without fine-tuning")
    _add_device_flag(sp)
    sp.set_defaults(fn=cmd_finetune)

    sp = sub.add_parser("train-cross", help="train on one dataset, test on another")
    sp.add_argument("--train-dataset", default="youtube_ugc")
    sp.add_argument("--test-dataset", default="cvd_2014")
    sp.add_argument("--train-metadata", required=True)
    sp.add_argument("--test-metadata", required=True)
    sp.add_argument("--train-features", required=True)
    sp.add_argument("--test-features", required=True)
    sp.add_argument("--output", default="model/mlp_cross.npz")
    sp.add_argument("--epochs", type=int, default=20)
    sp.add_argument("--no-bn", action="store_true")
    _add_device_flag(sp)
    sp.set_defaults(fn=cmd_train_cross)

    sp = sub.add_parser("report", help="results tables from run logs (host only)")
    sp.add_argument("--log", action="append", default=[], metavar="METHOD=DATASET=PATH",
                    help="reference-format training log to parse (repeatable)")
    sp.add_argument("--vsfa-npy", action="append", default=[], metavar="DATASET=PATH",
                    help="VSFA results .npy to parse (repeatable)")
    sp.add_argument("--with-baseline", action="store_true",
                    help="append the reference's published intra-dataset rows")
    sp.add_argument("--output-csv", default=None)
    sp.set_defaults(fn=cmd_report)

    sp = sub.add_parser("visualize", help="the ViT's last-block attention over a frame pair's fragment")
    sp.add_argument("--frame", required=True, help="original frame PNG")
    sp.add_argument("--next-frame", required=True, help="successor frame PNG")
    sp.add_argument("--output", default="attention_overlay.png",
                    help="overlay PNG; a bare name or a directory gets attention_overlay.png inside it")
    _add_backbone_flags(sp)
    sp.set_defaults(fn=cmd_visualize)

    sp = sub.add_parser("parity", help="strict-parity checks against the reference")
    sp.add_argument("--check", choices=["head", "demo", "features", "production", "all"], default="head",
                    help="features: the f32 pipeline's 35,203 vector against the independent torch + cv2 + "
                    "PIL reference (no blobs needed); production: the port's shipped numerics on the "
                    "device (flow against cv2, bf16 against f32 features); all: every check whose inputs "
                    "are present, one JSON verdict")
    sp.add_argument("--dataset", default="konvid_1k")
    sp.add_argument("--features-mat", default=None)
    sp.add_argument("--metadata-csv", default=None)
    sp.add_argument("--result-mat", default=None)
    sp.add_argument("--expected-csv", default=None, help="log/predict_score/*.csv")
    sp.add_argument("--greyscale-report", default=None)
    sp.add_argument("--model", default=None, help="reference .pth (required for head/demo checks)")
    sp.add_argument("--imputer", default=None)
    sp.add_argument("--scaler", default=None)
    sp.add_argument("--no-bn", action="store_true")
    sp.add_argument("--video", default=None)
    sp.add_argument("--video-type", default="konvid_1k")
    sp.add_argument("--expected-mos", type=float, default=None)
    _add_backbone_flags(sp)
    sp.set_defaults(fn=cmd_parity)
    return p, dict(sub.choices)


# Subcommands --config does not feed: they read no RunConfig field
# (``metadata`` scans container conventions, not a RunConfig dataset;
# ``report`` parses external training logs).
CONFIG_EXCLUDED = {"metadata", "report"}


def _apply_config(argv, subparsers: dict) -> None:
    """Pre-scan ``argv`` for ``--config``; its RunConfig values become the
    defaults of every subcommand, as the JAX CLI's ``_apply_config`` sets
    them (explicit flags still win).  ``runtime.compilation_cache`` has no
    effect: the port's build cache is ``_native``'s."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    known, _ = pre.parse_known_args(argv)
    if not known.config:
        return
    from relaxtpu_torch.config import RunConfig

    cfg = RunConfig.load(known.config)
    ex, tr, rt = cfg.extract, cfg.train, cfg.runtime

    def set_defaults(name: str, **values) -> None:
        sp = subparsers[name]
        sp.set_defaults(**values)
        for a in sp._actions:  # a value from the file satisfies a required flag
            if a.required and values.get(a.dest) is not None:
                a.required = False

    backbone = dict(resnet_weights=ex.resnet_weights, vit_weights=ex.vit_weights,
                    bf16=ex.backbone_dtype == "bfloat16")
    mesh = dict(n_data=rt.n_data, n_model=rt.n_model)
    set_defaults("extract", dataset=ex.dataset, root=ex.data_root, metadata_dir=ex.metadata_dir,
                 output=ex.output_dir, decode_workers=rt.decode_workers, dispatch_ahead=rt.dispatch_ahead,
                 profile_dir=rt.profile_dir, ingest=ex.ingest, **mesh, **backbone)
    set_defaults("predict", video_type=ex.dataset, ingest=ex.ingest, **backbone)
    set_defaults("predict-batch", video_type=ex.dataset, ingest=ex.ingest, decode_workers=rt.decode_workers,
                 **mesh, **backbone)
    set_defaults("serve", video_type=ex.dataset, ingest=ex.ingest, **backbone)
    set_defaults("train", dataset=ex.dataset, metadata_dir=ex.metadata_dir, n_repeats=tr.n_repeats,
                 n_splits=tr.n_splits, batch_size=tr.batch_size, epochs=tr.epochs, lr=tr.initial_lr,
                 weight_decay=tr.weight_decay, select_criteria=tr.select_criteria, no_bn=not tr.use_bn,
                 no_kfold=not tr.kfold)
    set_defaults("train-lsvq", epochs=tr.epochs, batch_size=tr.batch_size, lr=tr.initial_lr,
                 weight_decay=tr.weight_decay, select_criteria=tr.select_criteria)
    set_defaults("finetune", dataset=ex.dataset, n_repeats=tr.n_repeats, epochs=tr.epochs, no_bn=not tr.use_bn)
    set_defaults("greyscale", dataset=ex.dataset, root=ex.data_root, metadata_dir=ex.metadata_dir)
    set_defaults("warmup", bucket=ex.frame_bucket, ingest=ex.ingest, **backbone)  # the bucket is ignored
    set_defaults("train-cross", epochs=tr.epochs, no_bn=not tr.use_bn)
    set_defaults("visualize", **backbone)
    set_defaults("parity", dataset=ex.dataset, **backbone)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    argv = sys.argv[1:] if argv is None else argv
    parser, subparsers = build_parser()
    _apply_config(argv, subparsers)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

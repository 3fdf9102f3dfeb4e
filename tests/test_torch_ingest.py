"""Container decode, BGR ingest and the entry points on containers: the
port against the JAX package on the same files.

Clips: mp4v-encoded with cv2 and raw I420 ``.yuv`` at 120x160 (one mp4 at
96x128), 4 raw frames at 4 fps (2 sampled frames, 2 pairs), and one-frame
clips; a depth-2 ViT in f32; weights from the torch oracles, into JAX
through relaxtpu's porters and into the port through
``relaxtpu_torch.models.porters``; a seeded MLP head and a scaler fitted on
seeded features.  Bounds: per-segment cosine >= 0.99999 and mean relative
error <= 1e-4 on vectors, 1e-4 on a MOS, bit-equality for decoded arrays
and probe dicts.

Fault 3 (a .yuv file): the JAX package decodes it through BGR in every
ingest mode, with the native rawvideo decoder (swscale) where that loads.
Before this slice the port always took the I420 route, whose frames are the
numpy converter's: on this file's .yuv clip they differ from swscale's on
86.2% of values, by up to 3 LSB, and against JAX's ``predict_file`` with the
decoder loaded the port's vector had mean relative errors of 2.7e-3
(resnet_stack), 5.7e-3 (vit_pool), 8.1e-4 (frag_resnet) and 3.7e-3
(frag_vit), cosines 0.999982 / 0.999984 / 0.999998 / 0.999990: above the
1e-4 bound.
"""

import io
import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import relaxtpu.cli.__main__ as jax_cli
import relaxtpu.io.native as jax_native
import relaxtpu.io.video as jv
from relaxtpu.data.store import FeatureStore as JaxStore
from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
from relaxtpu.model.mlp import Mlp as JaxMlp
from relaxtpu.model.scalers import FeatureScaler as JaxScaler
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit, compare_segments
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu.predict import VideoQualityPredictor as JaxPredictor
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.data.store import FeatureStore
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io import native
from relaxtpu_torch.io import video as tv
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.ops.colorspace import unpack_i420
from relaxtpu_torch.models.porters import mlp_from_jax, resnet50_from_jax, vit_from_jax
from relaxtpu_torch.predict import VideoQualityPredictor

H, W = 120, 160
NAN_ENTRIES = 15171 + 4608  # the fragment segments of a video with no pairs


def assert_vectors_close(ours, theirs):
    assert ours.shape == theirs.shape == (35203,)
    for seg, r in compare_segments(ours, theirs).items():
        assert r["cosine"] >= 0.99999, (seg, r)
        assert r["mean_abs_err_over_mean_abs"] <= 1e-4, (seg, r)


def chain(seed: int, h: int = H, w: int = W, n: int = 4) -> np.ndarray:
    frames, nxt = synthetic_correlated_video(np.random.default_rng(seed), n // 2, h, w)
    return np.stack([x for pair in zip(frames, nxt) for x in pair])


def write_mp4(path: str, frames: np.ndarray, fps: int = 4) -> str:
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (frames.shape[2], frames.shape[1]))
    for f in frames:
        vw.write(f)
    vw.release()
    return path


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this file's small programs: pytest-xdist runs
    several test processes at once, and a thread pool per process larger
    than its share of the cores makes each wait at its pool's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    yuv, one_yuv = str(d / "c.yuv"), str(d / "one.yuv")
    pack_i420(*bgr_to_yuv420(chain(3))).tofile(yuv)
    pack_i420(*bgr_to_yuv420(chain(6)[:1])).tofile(one_yuv)
    return {"a": write_mp4(str(d / "a.mp4"), chain(3)), "a2": write_mp4(str(d / "a2.mp4"), chain(4)),
            "b": write_mp4(str(d / "b.mp4"), chain(5, 96, 128)), "one": write_mp4(str(d / "one.mp4"), chain(6)[:1]),
            "yuv": yuv, "one_yuv": one_yuv, "dir": str(d)}


@pytest.fixture(scope="module")
def predictors():
    """One JAX/port predictor pair on one extractor pair for the file."""
    rn = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    vit = port_torch_vit(build_torch_vit(depth=2, seed=1).state_dict(), depth=2)
    jfx = JaxExtractor(rn, vit, dtype=jnp.float32, vit_depth=2)
    tfx = FeatureExtractor(resnet50_from_jax(rn), vit_from_jax(vit, depth=2),
                           dtype=torch.float32, vit_depth=2, device="cpu")
    rng = np.random.default_rng(4)
    v = JaxMlp().init(jax.random.PRNGKey(0), jnp.zeros((2, 35203)), train=False)
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": {
        "bn1": {"mean": rng.normal(0, 0.1, 256).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, 256).astype(np.float32)}}})
    feats = rng.normal(0, 0.3, (8, 35203))
    js = JaxScaler.fit(feats)
    return (JaxPredictor(jfx, v, js),
            VideoQualityPredictor(tfx, mlp_from_jax(v), FeatureScaler(js.fill, js.scale, js.offset)))


@pytest.fixture(scope="module")
def jax_results(predictors, clips):
    """JAX's vectors and MOS, computed once: (path, ingest) -> (vec, mos)."""
    jp = predictors[0]
    cache = {}

    def get(path, ingest, **geometry):
        key = (path, ingest, jax_native.available())
        if key not in cache:
            vec = np.asarray(jp.enqueue_file(path, ingest=ingest, **geometry))
            cache[key] = vec, jp.predict_feature(vec)
        return cache[key]
    return get


@pytest.fixture
def port_off(monkeypatch):
    """The port's native decoder forced off."""
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture
def both_off(monkeypatch, port_off):
    """Both packages' native decoders forced off (cv2 stays)."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


# ------------------------------------------------------------------- decode
def test_native_binding_matches_jax(clips):
    assert native.available() and native.load_error() is None
    idx = [0, 1, 3]
    for path, raw in ((clips["a"], None), (clips["yuv"], {"width": W, "height": H, "pixfmt": "yuv420p"})):
        with native.NativeDecoder(path, raw=raw) as ours, jax_native.NativeDecoder(path, raw=raw) as theirs:
            fields = ("width", "height", "framerate", "nb_frames", "pixfmt", "bitdepth", "bitrate")
            assert {f: getattr(ours, f) for f in fields} == {f: getattr(theirs, f) for f in fields}
            np.testing.assert_array_equal(ours.decode_selected(idx), theirs.decode_selected(idx))
            np.testing.assert_array_equal(ours.decode_selected_i420(idx), theirs.decode_selected_i420(idx))
    with pytest.raises(FileNotFoundError):
        native.NativeDecoder(clips["a"] + ".missing")


def decode_all(mod, path, geometry):
    out = {"sampled": mod.decode_sampled_frames(path, **geometry),
           "pairs": mod.decode_frame_pairs(path, **geometry),
           "inputs": mod.decode_video_inputs(path, **geometry)}
    if not path.endswith(".yuv"):
        out["probe"] = mod.probe_video(path)
    return out


@pytest.mark.parametrize("route", ["native", "cv2"])
@pytest.mark.parametrize("kind", ["mp4", "yuv"])
def test_decoders_match_jax(clips, request, route, kind):
    """Every decode function on the same file, bit-equal: with the native
    decoder loaded in both packages, and with it forced off in both (cv2 for
    containers; the numpy converter for .yuv)."""
    if route == "cv2":
        request.getfixturevalue("both_off")
    path = clips["a"] if kind == "mp4" else clips["yuv"]
    geometry = {} if kind == "mp4" else dict(framerate=4.0, width=W, height=H)
    ours, theirs = decode_all(tv, path, geometry), decode_all(jv, path, geometry)
    assert ours.keys() == theirs.keys()
    assert ours.pop("probe", None) == theirs.pop("probe", None)
    for key in ours:
        arrays = [x if isinstance(x, tuple) else (x,) for x in (ours[key], theirs[key])]
        for a, b in zip(*arrays):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    frames, prev, nxt = ours["inputs"]
    assert frames.shape == (2, H, W, 3) and nxt.shape == (2, H, W, 3)
    assert np.shares_memory(prev, frames)  # the prefix view the BGR program uploads once
    if kind == "mp4" and route == "native":
        fb, nb, h, w = tv.decode_video_inputs_i420(path)
        jfb, jnb, jh, jw = jv.decode_video_inputs_i420(path)
        assert (h, w) == (jh, jw) == (H, W)
        np.testing.assert_array_equal(fb, jfb)
        np.testing.assert_array_equal(nb, jnb)


def test_no_decoder_raises_a_named_error(clips, port_off, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(tv.DecoderUnavailable, match="native decoder does not load.*cv2 is not installed"):
        tv.decode_video(clips["a"], ingest="auto")
    kind, data = tv.decode_video(clips["yuv"], 4.0, W, H)  # a raw file needs neither
    assert kind == "i420" and data[0].shape == (2, H * W * 3 // 2)


def test_decode_video_routes(clips, monkeypatch):
    assert tv.decode_video(clips["a"], ingest="auto")[0] == "i420"
    assert tv.decode_video(clips["a"], ingest="bgr")[0] == "bgr"
    assert tv.decode_video(clips["yuv"], 4.0, W, H, ingest="yuv")[0] == "bgr"  # JAX's .yuv decode
    # a metadata geometry that is not the stream's: auto decodes BGR, yuv refuses
    assert tv.decode_video(clips["a"], 4.0, W + 2, H, ingest="auto")[0] == "bgr"
    with pytest.raises(tv.I420Unavailable, match="geometry"):
        tv.decode_video(clips["a"], 4.0, W + 2, H, ingest="yuv")
    monkeypatch.setattr(native, "available", lambda: False)
    assert tv.decode_video(clips["a"], ingest="auto")[0] == "bgr"
    with pytest.raises(tv.I420Unavailable, match="native decoder"):
        tv.decode_video(clips["a"], ingest="yuv")


# ------------------------------------------------------------------ vectors
def test_video_feature_async_matches_jax(predictors, clips, monkeypatch):
    """The BGR program on the .yuv clip's frames against JAX's; frames go up
    once (prev is their prefix view); the BGR program on the host
    converter's frames of the clip's I420 bytes, and
    ``video_feature_async_yuv`` on those bytes' planes, equal the I420
    program; with ``max_pair_batch`` 1 the BGR program takes the chunked
    path."""
    jp, tp = predictors
    tfx = tp.extractor
    frames, prev, nxt = tv.decode_video_inputs(clips["yuv"], 4.0, W, H)
    uploads = []
    upload = tfx.upload
    monkeypatch.setattr(tfx, "upload", lambda arrays: uploads.append(len(arrays[0])) or upload(arrays))
    vec = tfx.video_feature_async(frames, prev, nxt)
    assert uploads == [2, 2] and vec.shape == (35203,) and vec.device.type == "cpu"
    monkeypatch.undo()
    want = np.asarray(jp.extractor.video_feature_async(frames, prev, nxt))
    assert_vectors_close(vec.numpy(), want)
    fb, nb, h, w = tv.decode_video_inputs_i420(clips["yuv"], 4.0, W, H)
    i420 = tfx.video_feature_async_i420(fb, nb, h, w).numpy()
    host = [np.stack([tv._yuv420_to_bgr_limited(r.reshape(h * 3 // 2, w), w, h) for r in b]) for b in (fb, nb)]
    np.testing.assert_array_equal(tfx.video_feature_async(host[0], host[0], host[1]).numpy(), i420)
    planes = [tuple(t.numpy() for t in unpack_i420(torch.from_numpy(b), h, w)) for b in (fb, nb)]
    np.testing.assert_array_equal(tfx.video_feature_async_yuv(*planes).numpy(), i420)
    calls = []
    inner = FeatureExtractor._pair_rows
    monkeypatch.setattr(FeatureExtractor, "max_pair_batch", lambda self, h, w: 1)
    monkeypatch.setattr(FeatureExtractor, "_pair_rows",
                        lambda self, *a: calls.append(a[-1]) or inner(self, *a))
    assert_vectors_close(tfx.video_feature_async(frames, prev, nxt).numpy(), want)
    assert calls == [1]


@pytest.mark.parametrize("ingest", ["bgr", "yuv", "auto"])
def test_predict_file_mp4_matches_jax(predictors, clips, jax_results, ingest):
    tp = predictors[1]
    want_vec, want = jax_results(clips["a"], ingest)
    if ingest == "bgr":
        got = tp.predict_file(clips["a"], ingest=ingest)
    else:  # the vector too (the MOS is predict_file's: predict_feature of it)
        vec = tp.enqueue_file(clips["a"], ingest=ingest)
        assert_vectors_close(vec.numpy(), want_vec)
        got = tp.predict_feature(vec)
    assert np.isfinite(got) and abs(got - want) <= 1e-4, (got, want)


@pytest.mark.parametrize("decoder", ["native", "forced_off"])
def test_predict_file_yuv_matches_jax(predictors, clips, jax_results, request, decoder):
    """Fault 3: a .yuv file gives JAX's ``predict_file`` with the native
    decoder loaded (the port's BGR route) and with it forced off in both
    packages (the port's I420 route, JAX's numpy converter); every ingest
    mode decodes it alike."""
    if decoder == "forced_off":
        request.getfixturevalue("both_off")
    tp = predictors[1]
    geometry = dict(framerate=4.0, width=W, height=H)
    want_vec, want = jax_results(clips["yuv"], "auto", **geometry)
    kind, data = tv.decode_video(clips["yuv"], ingest="auto", **geometry)
    assert kind == ("bgr" if decoder == "native" else "i420")
    for ingest in ("bgr", "yuv"):
        other = tv.decode_video(clips["yuv"], ingest=ingest, **geometry)
        assert other[0] == kind and all(np.array_equal(a, b) for a, b in zip(other[1], data))
    vec = tp.enqueue_file(clips["yuv"], ingest="auto", **geometry)
    assert_vectors_close(vec.numpy(), want_vec)
    got = tp.predict_file(clips["yuv"], ingest="bgr", **geometry)
    assert abs(got - want) <= 1e-4, (got, want)


def test_one_frame_clip_matches_jax(predictors, clips, jax_results):
    """Fault 1: a clip with one sampled frame and no pairs.  The I420 route
    (the mp4 with auto or yuv ingest) scores it, NaN in exactly JAX's
    fragment entries; the BGR decode raises in both packages (the mp4 with
    bgr ingest, and a .yuv file in every mode)."""
    jp, tp = predictors
    want_vec, want = jax_results(clips["one"], "auto")
    vec = tp.enqueue_file(clips["one"], ingest="auto").numpy()
    nan = np.isnan(vec)
    np.testing.assert_array_equal(nan, np.isnan(want_vec))
    assert nan.sum() == NAN_ENTRIES and nan[-NAN_ENTRIES:].all()
    keep = slice(0, 35203 - NAN_ENTRIES)
    for a, b in ((vec[:13120], want_vec[:13120]), (vec[13120:keep.stop], want_vec[13120:keep.stop])):
        cos = a.astype(np.float64) @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.99999 and np.abs(a - b).mean() / np.abs(b).mean() <= 1e-4
    got = tp.predict_file(clips["one"], ingest="yuv")
    assert np.isfinite(got) and abs(got - want) <= 1e-4
    for pkg, path, ingest, geometry in ((jp, clips["one"], "bgr", {}), (tp, clips["one"], "bgr", {}),
                                        (jp, clips["one_yuv"], "auto", dict(framerate=4.0, width=W, height=H)),
                                        (tp, clips["one_yuv"], "auto", dict(framerate=4.0, width=W, height=H))):
        with pytest.raises(ValueError):
            pkg.predict_file(path, ingest=ingest, **geometry)


def test_one_frame_yuv_raises_without_native(predictors, clips, port_off):
    with pytest.raises(ValueError, match="no frame pairs"):
        predictors[1].predict_file(clips["one_yuv"], 4.0, W, H)


# ------------------------------------------------------------- entry points
def test_predict_batch_groups_by_resolution(predictors, clips, jax_results, tmp_path, capsys, monkeypatch):
    """A directory of two mp4s at 120x160, one at 96x128, a one-frame mp4
    and a .yuv, ``--batch 2``: the 120x160 pair runs as one batched program,
    the others as single programs, the .yuv through the BGR program; rows in
    input order.  Each container's row is within 1e-4 of the JAX CLI's
    ``predict-batch`` row on the same directory (which globs no .yuv), the
    .yuv's of JAX's ``predict_file``.  The JAX CLI runs at ``--batch 1``,
    each video through its single-video program: its batched program raises
    on a video with no pairs (a reshape divides by the pair count 0)."""
    jp, tp = predictors
    d = tmp_path / "vids"
    d.mkdir()
    for name in ("a", "a2", "b", "one", "yuv"):
        os.symlink(clips[name], d / os.path.basename(clips[name]))
    monkeypatch.setattr(cli, "_build_extractor", lambda args: None)
    monkeypatch.setattr(cli, "_load_predictor", lambda args, extractor: tp)
    batched, single, bgr = [], [], []
    fx = tp.extractor
    for name, log_ in (("video_features_batch_i420", batched), ("video_feature_async_i420", single),
                       ("video_feature_async", bgr)):
        inner = getattr(fx, name)
        monkeypatch.setattr(fx, name, lambda *a, inner=inner, log_=log_: log_.append(len(a[0])) or inner(*a))
    argv = ["predict-batch", "--videos", str(d), "--model", "m.npz", "--imputer", "i.pkl", "--scaler", "s.pkl"]
    cli.main([*argv, "--batch", "2", "--framerate", "4", "--width", str(W), "--height", str(H), "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    order = [str(d / n) for n in ("a.mp4", "a2.mp4", "b.mp4", "one.mp4", "c.yuv")]
    assert [r["video"] for r in lines] == order
    assert batched == [2] and sorted(single) == [1, 2] and bgr == [2]
    monkeypatch.undo()
    monkeypatch.setattr(jax_cli, "_build_extractor", lambda args: jp.extractor)
    monkeypatch.setattr(jax_cli, "_load_predictor", lambda args, extractor: jp)
    jax_cli.main([*argv, "--batch", "1"])
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["video"] for r in want] == order[:4]
    want.append({"video": order[4],
                 "predicted_mos": jax_results(clips["yuv"], "auto", framerate=4.0, width=W, height=H)[1]})
    for r, w in zip(lines, want, strict=True):
        assert np.isfinite(r["predicted_mos"]) and abs(r["predicted_mos"] - w["predicted_mos"]) <= 1e-4, (r, w)


def test_predict_batch_auto_probes_the_link(predictors, clips, monkeypatch):
    probes = []
    monkeypatch.setattr("relaxtpu_torch.utils.linkprobe.measure_link",
                        lambda **kw: probes.append(kw) or {"link_MBps": 1e4, "link_MBps_worst": 1e4, "rtt_ms": 50.0})
    rows = cli.predict_batch(predictors[1], [clips["a"], clips["a2"]],
                             lambda p: tv.decode_video(p, ingest="auto"), batch="auto")
    assert len(probes) == 1 and [p for p, _ in rows] == [clips["a"], clips["a2"]]
    assert all(np.isfinite(m) for _, m in rows)


def test_serve_loop_on_containers(predictors, clips, jax_results):
    """Each response against JAX's ``enqueue_file`` on the same request (what
    the JAX package's ``serve`` scores, with ``auto`` ingest): a MOS within
    1e-4 of JAX's, or an error where JAX's raises (the one-frame .yuv, whose
    BGR decode has no pairs, and a missing file)."""
    tp = predictors[1]
    geometry = dict(framerate=4.0, width=W, height=H)
    videos = [clips["a"], clips["yuv"], clips["one_yuv"], clips["one"], clips["a"] + ".missing"]
    requests = [videos[0], json.dumps({"video": videos[1]}), *videos[2:]]
    out = io.StringIO()
    cli.serve_loop(tp, iter(requests), out, in_flight=2, defaults=geometry, ingest="auto")
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert lines[0] == {"status": "ready"} and len(lines) == 6
    assert ["error" in r for r in lines[1:]] == [False, False, True, False, True]
    for row, path in zip(lines[1:], videos, strict=True):
        assert row["video"] == path
        try:
            want = jax_results(path, "auto", **(geometry if path.endswith(".yuv") else {}))[1]
        except (ValueError, FileNotFoundError):
            assert "error" in row, row
        else:
            assert abs(row["predicted_mos"] - want) <= 1e-4, (row, want)


def write_dataset(root, clips, vids) -> str:
    """<root>/KoNViD_1k_videos/<vid>.mp4 and a metadata CSV without a frame
    rate; a's row has no geometry, a2's width is not its stream's (so auto
    decodes it BGR)."""
    os.makedirs(os.path.join(root, "KoNViD_1k_videos"))
    rows = {"a": "a,3.1,,", "a2": f"a2,2.5,{W + 2},{H}", "one": f"one,4.0,{W},{H}"}
    for vid in vids:
        os.symlink(clips[vid], os.path.join(root, "KoNViD_1k_videos", f"{vid}.mp4"))
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w") as f:
        f.write("vid,mos,width,height\n" + "".join(rows[v] + "\n" for v in vids))
    return meta


@pytest.mark.parametrize("mode", ["full", "layer_stack"])
def test_extract_on_containers_matches_jax_cli(predictors, clips, tmp_path, capsys, monkeypatch, mode):
    """``extract`` on a konvid_1k-named mp4 dataset against the JAX CLI's
    rows.  full: I420 for a and for the one-frame clip (NaN fragment
    entries), BGR for a2; layer_stack (an ablation mode): BGR for every
    video, as in the JAX CLI, whose BGR decode of a clip with no pairs
    raises (so the one-frame clip is left out)."""
    jp, tp = predictors
    vids = ("a", "a2", "one") if mode == "full" else ("a", "a2")
    meta = write_dataset(str(tmp_path), clips, vids)
    monkeypatch.setattr(cli, "_build_extractor", lambda args: tp.extractor)
    monkeypatch.setattr(jax_cli, "_build_extractor", lambda args: jp.extractor)
    argv = ["extract", "--dataset", "konvid_1k", "--metadata-csv", meta, "--root", str(tmp_path), "--mode", mode]
    cli.main([*argv, "--output", str(tmp_path / "port"), "--device", "cpu", "--f32"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main([*argv, "--output", str(tmp_path / "jax")])
    assert line == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["shape"] == [len(vids), 35203 if mode == "full" else 13120]
    tag = "konvid_1k" if mode == "full" else "konvid_1k_layer_stack"
    for i in range(len(vids)):
        ours, theirs = FeatureStore(str(tmp_path / "port")).get(tag, i), JaxStore(str(tmp_path / "jax")).get(tag, i)
        if mode == "layer_stack":
            for a, b in zip(ours.astype(np.float64), theirs.astype(np.float64)):
                assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99999
                assert np.abs(a - b).mean() / np.abs(b).mean() <= 1e-4
        elif vids[i] == "one":
            np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
            keep = ~np.isnan(theirs)
            assert np.abs(ours[keep] - theirs[keep]).mean() / np.abs(theirs[keep]).mean() <= 1e-4
        else:
            assert_vectors_close(ours, theirs)

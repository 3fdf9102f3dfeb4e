"""The multi-device layer (``relaxtpu_torch.parallel`` and the CLI's
``--n-data``/``--n-model``) on the CPU with gloo, against the JAX package's
``relaxtpu.parallel`` on its virtual CPU mesh and against the port's
one-process runs.

Ranks are real processes: ``torch.multiprocessing`` spawns them, each runs
one worker function of this file on one torch thread and writes what it saw
to a file, and every group is joined with a timeout (a rank that fails
fails the group at once).  The two-rank group joins through torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
the four-rank group through a ``file://`` store.  Both groups start before
the JAX programs compile in the test process.  JAX is imported inside the
fixtures, so the spawned ranks load only torch and the port.

Clips: three 64x96 videos of 4 raw frames at 4 fps (2 frames, 2 pairs);
weights from the torch oracles (ResNet-50, depth-2 ViT, f32), into JAX
through relaxtpu's porters and into the port through its porters.  Bounds:
per-segment cosine >= 0.99999 and mean relative error <= 1e-4 against JAX
(the pipeline tests' bounds), bit-equality against the port's one-process
runs of the same programs; the DP x TP step at the real head shape
(35,203 x 256, batch 16) against JAX's within 1e-4 on the loss and rtol
1e-4, atol 1e-5 on the parameters (``tests/test_parallel.py``'s bounds).
"""

import contextlib
import datetime
import io
import json
import logging
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.data.store import FeatureStore
from relaxtpu_torch.device import resolve_device
from relaxtpu_torch.features.layout import FRAG_RESNET_DIM, FRAG_VIT_DIM
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.model.mlp import Mlp, flax_init_
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.model.train import MlpTrainer, TrainConfig, make_optimizer
from relaxtpu_torch.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu_torch.parallel.distributed import allgather_video_features, initialize, shard_videos
from relaxtpu_torch.parallel.eval import ShardedVideoEvaluator
from relaxtpu_torch.parallel.mesh import make_mesh, shard_batch
from relaxtpu_torch.parallel.train_dp import DistributedMlpTrainStep
from relaxtpu_torch.predict import VideoQualityPredictor

H, W = 64, 96
DIM, HIDDEN, BATCH = 35203, 256, 16
GROUP_TIMEOUT_S = 240
SHORT_TIMEOUT_S, SLOW_RANK0_S = 10, 25  # a group timeout rank 0's one-device run outlives


# ------------------------------------------------------------------ launch
def _rank_main(rank: int, fn, world: int, init: str, out_dir: str, args, timeout_s: int) -> None:
    """One rank: join the group (torchrun's environment when ``init`` is
    "env", else a file store) with a ``timeout_s`` group timeout, run
    ``fn``, save what it returns.  The ranks meet at a barrier before they
    end, except in a group with a shorter timeout than ``GROUP_TIMEOUT_S``,
    whose ranks may end far apart."""
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=timeout_s)
    if init == "env":
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        initialize(device="cpu", timeout=timeout)
    else:
        initialize(init, world, rank, device="cpu", timeout=timeout)
    result = fn(rank, *args)
    if timeout_s >= GROUP_TIMEOUT_S:
        dist.barrier()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """``fn(rank, *args)`` on ``world`` spawned ranks, started at once;
    :meth:`results` joins them and gives each rank's result.  It fails when
    a rank raises or the group outlives ``GROUP_TIMEOUT_S``.  ``timeout_s``
    is the timeout of the ranks' process group."""

    def __init__(self, fn, world: int, tmp, *args, init: str = "file", timeout_s: int = GROUP_TIMEOUT_S):
        self.name, self.world, self.out_dir = fn.__name__, world, tmp / f"ranks_{fn.__name__}"
        self.out_dir.mkdir()
        saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT")}
        if init == "env":  # the ranks copy the environment when they start
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        else:
            init = f"file://{tmp / f'store_{fn.__name__}'}"
        try:
            self.ctx = mp.start_processes(_rank_main, args=(fn, world, init, str(self.out_dir), args, timeout_s),
                                          nprocs=world, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self.deadline = time.monotonic() + GROUP_TIMEOUT_S
        self._results = None

    def results(self) -> list:
        while self._results is None and not self.ctx.join(timeout=max(self.deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                pytest.fail(f"{self.name}: {self.world} ranks still running after {GROUP_TIMEOUT_S} s")
        if self._results is None:
            self._results = [torch.load(self.out_dir / f"rank{r}.pt", weights_only=False)
                             for r in range(self.world)]
        return self._results


# ------------------------------------------------------------------ inputs
def extractor_from(states: dict) -> FeatureExtractor:
    return FeatureExtractor(states["resnet"], states["vit"], dtype=torch.float32, vit_depth=2, device="cpu")


def predictor_from(states: dict, fx) -> VideoQualityPredictor:
    return VideoQualityPredictor(fx, states["mlp"], FeatureScaler(*states["scaler"]))


def decode_clip(clips: dict):
    """The evaluator's decode of clip ``(i, kind)``: I420 or BGR forms."""
    def decode(v):
        i, kind = v
        frames, nxt = clips["frames"][i], clips["nxt"][i]
        if kind == "i420":
            return "i420", pack_i420(*bgr_to_yuv420(frames)), pack_i420(*bgr_to_yuv420(nxt)), H, W
        return frames, frames[: len(nxt)], nxt
    return decode


VIDEOS = [(0, "i420"), (1, "bgr"), (2, "i420")]


def cli_args(setup: dict, *argv) -> list:
    return ["extract", "--dataset", "konvid_1k", "--metadata-csv", setup["meta"], "--root", setup["root"],
            "--device", "cpu", *argv]


def predict_args(setup: dict, *argv) -> list:
    return ["predict-batch", "--videos", *setup["mp4s"], "--model", "m.npz", "--imputer", "i.pkl",
            "--scaler", "s.pkl", "--device", "cpu", *argv]


@contextlib.contextmanager
def patched_cli(fx, predictor=None):
    """The port's CLI builds ``fx`` (and ``predictor``) instead of seeded
    full-width backbones."""
    saved = cli._build_extractor, cli._load_predictor
    cli._build_extractor = lambda args: fx
    cli._load_predictor = lambda args, extractor: predictor
    try:
        yield
    finally:
        cli._build_extractor, cli._load_predictor = saved


def run_cli(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


class Calls:
    """Counts calls of the single-video programs while inside."""

    names = ("video_feature_async_i420", "video_feature_async")

    def __init__(self, fx):
        self.fx, self.n = fx, 0

    def __enter__(self):
        for name in self.names:
            inner = getattr(self.fx, name)
            setattr(self.fx, name, lambda *a, inner=inner: setattr(self, "n", self.n + 1) or inner(*a))
        return self

    def __exit__(self, *exc):
        for name in self.names:
            delattr(self.fx, name)


# ------------------------------------------------------------------ workers
def _two_ranks(rank: int, setup: dict) -> dict:
    """Everything the (2, 1) mesh runs, in one group."""
    out = {}
    mesh = make_mesh(2, 1, "cpu")
    out["mesh"] = (mesh.rank, mesh.data_index, mesh.model_index, mesh.shape)

    full = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    mine = shard_videos(range(5))
    out["allgather_5"] = allgather_video_features(mine, full[mine], 5)

    states = torch.load(setup["states"], weights_only=False)
    clips = dict(np.load(setup["clips"]))
    fx = extractor_from(states)
    ev = ShardedVideoEvaluator(fx, mesh, decode_workers=2)
    seen = []
    out["run"] = ev.run(VIDEOS, decode_clip(clips), on_result=lambda i, vec: seen.append(i))
    out["run_seen"] = seen
    i420 = [(pack_i420(*bgr_to_yuv420(f)), pack_i420(*bgr_to_yuv420(n))) for f, n in zip(clips["frames"], clips["nxt"])]
    out["batch3"] = ev.videos_batch_feature_i420([a for a, _ in i420], [b for _, b in i420], H, W).numpy()
    frames, nxt = clips["frames"][1], clips["nxt"][1]
    out["video_feature"] = ev.video_feature(frames, frames[: len(nxt)], nxt)
    out["video_feature_one_frame"] = ev.video_feature(frames[:1], frames[:0], nxt[:0])

    # the 2 x 1 step with dropout against the one-process step, same generator
    data = np.load(setup["head"])
    x, y = data["x"], data["y"]
    init = flax_init_(Mlp(DIM, HIDDEN, use_bn=False), torch.Generator().manual_seed(3)).state_dict()
    step = DistributedMlpTrainStep(mesh, DIM, drop_rate=0.1)
    step.init(state=init)
    gen = torch.Generator().manual_seed(5)
    xs, ys, _ = shard_batch(mesh, x, y)
    out["dropout_loss"] = [float(step.step(xs, ys, gen)) for _ in range(3)]
    out["dropout_state"] = step.state()
    trainer = MlpTrainer(TrainConfig(use_bn=False, drop_rate=0.1), DIM, "cpu")
    model = trainer.train_model(init)
    opt = make_optimizer(trainer.cfg, model.parameters())
    gen = torch.Generator().manual_seed(5)
    out["one_loss"] = [float(trainer.step(model, opt, torch.from_numpy(x), torch.from_numpy(y), gen))
                       for _ in range(3)]
    out["one_state"] = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # the CLI under torchrun's environment
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger().addHandler(handler)
    with patched_cli(fx, predictor_from(states, fx)), Calls(fx) as calls:
        out["extract_stdout"] = run_cli(cli_args(setup, "--output", setup["mesh_out"], "--n-data", "2"))
        out["extract_calls"] = calls.n
        out["resume_stdout"] = run_cli(cli_args(setup, "--output", setup["mesh_out"], "--n-data", "2"))
        out["resume_calls"] = calls.n - out["extract_calls"]
        out["stack_stdout"] = run_cli(cli_args(setup, "--output", setup["stack_out"], "--n-data", "2",
                                               "--mode", "layer_stack"))
        out["predict_stdout"] = run_cli(predict_args(setup, "--n-data", "2", "--output-csv",
                                                     setup["csv"] + f".rank{rank}"))
    out["warnings"] = [m for m in records if "supports --mode full only" in m]
    return out


def _slow_rank0(rank: int, argv: list) -> dict:
    """A non-full mode on a mesh whose group times out after
    ``SHORT_TIMEOUT_S``: rank 0's one-device run (a stand-in that sleeps
    ``SLOW_RANK0_S``) outlives it."""
    ran = []
    saved = cli._extract
    cli._extract = lambda args: ran.append(args.mode) or time.sleep(SLOW_RANK0_S)
    try:
        t0 = time.monotonic()
        cli.main(argv)
        return {"ran": ran, "s": time.monotonic() - t0}
    finally:
        cli._extract = saved


def _four_ranks(rank: int, head: str) -> dict:
    """The 2 x 2 DP x TP step at the real head shape, from JAX's init;
    gathers over 3 of the 4 ranks (a subgroup) with uneven counts; meshes
    the world of 4 cannot fill."""
    data = torch.load(head, weights_only=False)
    mesh = make_mesh(2, 2, "cpu")
    step = DistributedMlpTrainStep(mesh, DIM, drop_rate=0.0)
    step.init(state=data["init"])
    xs, ys, _ = shard_batch(mesh, data["x"], data["y"])
    out = {"mesh": (mesh.rank, mesh.data_index, mesh.model_index), "cols": step.cols,
           "loss": [float(step.step(xs, ys)) for _ in range(data["steps"])], "state": step.state(keep_pad=True)}

    full = np.random.default_rng(1).normal(size=(5, 8)).astype(np.float32)
    three = dist.new_group([0, 1, 2])
    if rank < 3:
        for n in (5, 2):  # 2 videos on 3 ranks: rank 2 has none
            mine = shard_videos(range(n), rank, 3)
            out[f"allgather_{n}"] = allgather_video_features(mine, full[mine], n, group=three)
    out["errors"] = []
    for args in ((3, 1), (None, 8), (None, 3)):
        try:
            make_mesh(*args, device="cpu")
        except ValueError as e:
            out["errors"].append(str(e))
    return out


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """One JAX extractor and predictor, and the port's states, on the same
    weights."""
    import jax
    import jax.numpy as jnp

    from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
    from relaxtpu.model.mlp import Mlp as JaxMlp
    from relaxtpu.model.scalers import FeatureScaler as JaxScaler
    from relaxtpu.models import port_torch_resnet50, port_torch_vit
    from relaxtpu.oracle import build_torch_resnet50, build_torch_vit
    from relaxtpu.predict import VideoQualityPredictor as JaxPredictor
    from relaxtpu_torch.models.porters import mlp_from_jax, resnet50_from_jax, vit_from_jax

    rn = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    vit = port_torch_vit(build_torch_vit(depth=2, seed=1).state_dict(), depth=2)
    jfx = JaxExtractor(rn, vit, dtype=jnp.float32, vit_depth=2)
    v = JaxMlp().init(jax.random.PRNGKey(0), jnp.zeros((2, DIM)), train=False)
    rng = np.random.default_rng(4)
    v = jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": {
        "bn1": {"mean": rng.normal(0, 0.1, 256).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, 256).astype(np.float32)}}})
    js = JaxScaler.fit(rng.normal(0, 0.3, (8, DIM)))
    states = {"resnet": resnet50_from_jax(rn), "vit": vit_from_jax(vit, depth=2), "mlp": mlp_from_jax(v),
              "scaler": (js.fill, js.scale, js.offset)}
    fx = extractor_from(states)
    return {"jax": JaxPredictor(jfx, v, js), "states": states, "fx": fx, "predictor": predictor_from(states, fx)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory, models):
    """Clips, a konvid_1k-named mp4 dataset of the same clips, and the
    files the ranks read."""
    import cv2

    from relaxtpu.parity import synthetic_correlated_video

    d = tmp_path_factory.mktemp("parallel")
    frames, nxt = zip(*(synthetic_correlated_video(np.random.default_rng(s), 2, H, W) for s in (3, 4, 5)))
    np.savez(d / "clips.npz", frames=np.stack(frames), nxt=np.stack(nxt))
    os.makedirs(d / "KoNViD_1k_videos")
    mp4s = []
    for i, (f, n) in enumerate(zip(frames, nxt)):
        path = str(d / "KoNViD_1k_videos" / f"v{i}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 4, (W, H))
        for img in (f[0], n[0], f[1], n[1]):
            vw.write(img)
        vw.release()
        mp4s.append(path)
    with open(d / "meta.csv", "w") as fh:
        fh.write("vid,mos\n" + "".join(f"v{i},{3 + i * 0.5}\n" for i in range(3)))
    torch.save(models["states"], d / "states.pt")
    rng = np.random.default_rng(7)
    np.savez(d / "head.npz", x=rng.normal(size=(BATCH, DIM)).astype(np.float32),
             y=rng.uniform(1, 5, BATCH).astype(np.float32))
    return {"root": str(d), "meta": str(d / "meta.csv"), "mp4s": mp4s, "clips": str(d / "clips.npz"),
            "states": str(d / "states.pt"), "head": str(d / "head.npz"), "mesh_out": str(d / "mesh_out"),
            "stack_out": str(d / "stack_out"), "csv": str(d / "rows.csv"), "dir": d}


@pytest.fixture(scope="module")
def jax_head(tmp_path_factory):
    """JAX's ``DistributedMlpTrainStep`` on make_mesh(2, 2, platform="cpu"):
    its init (as the port's state) and the inputs of 2 steps, in a file."""
    import jax

    from relaxtpu.parallel.mesh import make_mesh as jax_make_mesh
    from relaxtpu.parallel.train_dp import DistributedMlpTrainStep as JaxStep
    from relaxtpu_torch.models.porters import mlp_from_jax

    rng = np.random.default_rng(8)
    x = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    y = rng.uniform(1, 5, size=(BATCH,)).astype(np.float32)
    step = JaxStep(jax_make_mesh(2, 2, platform="cpu"), input_dim=DIM, hidden=HIDDEN, use_bn=False, drop_rate=0.0)
    params, opt_state = step.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    init["fc1"]["kernel"] = init["fc1"]["kernel"][:DIM]
    d = tmp_path_factory.mktemp("dp_tp")
    torch.save({"init": mlp_from_jax({"params": init}), "x": x, "y": y, "steps": 2}, d / "head.pt")
    return {"step": step, "params": params, "opt_state": opt_state, "x": x, "y": y, "file": d / "head.pt"}


@pytest.fixture(scope="module")
def groups(setup, jax_head, tmp_path_factory):
    """Both rank groups, started before the JAX programs compile here."""
    return {"two": Group(_two_ranks, 2, tmp_path_factory.mktemp("two"), setup, init="env"),
            "four": Group(_four_ranks, 4, tmp_path_factory.mktemp("four"), str(jax_head["file"])),
            "slow0": Group(_slow_rank0, 2, tmp_path_factory.mktemp("slow0"),
                           cli_args(setup, "--output", str(setup["dir"] / "slow0_out"), "--n-data", "2",
                                    "--mode", "layer_stack"), timeout_s=SHORT_TIMEOUT_S)}


@pytest.fixture(scope="module")
def two(groups):
    return groups["two"].results()


@pytest.fixture(scope="module")
def four(groups):
    return groups["four"].results()


@pytest.fixture(scope="module")
def clips(setup):
    return dict(np.load(setup["clips"]))


@pytest.fixture(scope="module")
def jax_mesh():
    from relaxtpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(2, 1, platform="cpu")


def assert_vectors_close(ours, theirs):
    from relaxtpu.oracle import compare_segments

    assert ours.shape == theirs.shape == (DIM,)
    for seg, r in compare_segments(np.asarray(ours), np.asarray(theirs)).items():
        assert r["cosine"] >= 0.99999, (seg, r)
        assert r["mean_abs_err_over_mean_abs"] <= 1e-4, (seg, r)


def one_process_rows(fx, clips) -> list:
    decode = decode_clip(clips)
    rows = []
    for v in VIDEOS:
        res = decode(v)
        vec = fx.video_feature_async_i420(*res[1:]) if isinstance(res[0], str) else fx.video_feature_async(*res)
        rows.append(vec.numpy())
    return rows


# ---------------------------------------------------- JAX, while ranks run
@pytest.fixture(scope="module")
def jax_rows(groups, models, clips, jax_mesh):
    """JAX's ``ShardedVideoEvaluator.run`` on a (2, 1) CPU mesh: I420, BGR,
    I420 (the file's first JAX programs compile while the ranks run)."""
    from relaxtpu.parallel.eval import ShardedVideoEvaluator as JaxEvaluator

    jev = JaxEvaluator(models["jax"].extractor, jax_mesh, decode_workers=2)
    return [np.asarray(v) for v in jev.run(VIDEOS, decode_clip(clips))]


def test_sharded_run_matches_jax(jax_rows, two):
    """``run`` on 2 ranks against JAX's ``ShardedVideoEvaluator.run``."""
    for res in two:
        assert len(res["run"]) == 3
        for got, w in zip(res["run"], jax_rows, strict=True):
            assert_vectors_close(got, w)


# -------------------------------------------------------------------- mesh
def test_mesh_order_matches_jax_grid(dp_tp):
    """rank -> (data, model) is the row-major order of JAX's device grid
    (``make_mesh(2, 2, platform="cpu")``), and each rank keeps its model
    index's block of fc1's input rows."""
    from relaxtpu.parallel.mesh import make_mesh as jax_make_mesh

    grid = np.vectorize(lambda d: d.id)(jax_make_mesh(2, 2, platform="cpu").devices)
    for r, res in enumerate(dp_tp["ranks"]):
        rank, d, m = res["mesh"]
        assert rank == r and grid[d, m] == r
        assert res["cols"] == (m * (DIM + 1) // 2, (m + 1) * (DIM + 1) // 2)


def test_mesh_without_process_group():
    """A world of one: the (1, 1) mesh; any other shape raises, also
    ``n_data=None`` with a model axis the world cannot fill."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None
    for args, match in (((2, 1), "mesh needs 2 ranks"), ((None, 2), "2 ranks on the model axis"),
                        ((1, 0), "positive")):
        with pytest.raises(ValueError, match=match):
            make_mesh(*args, device="cpu")


def test_mesh_raises_when_the_world_differs(four):
    for res in four:
        assert res["errors"] == [
            "mesh needs 3 ranks (data=3 x model=1); the world has 4",
            "mesh needs 8 ranks on the model axis; the world has 4",
            "mesh needs 3 ranks (data=1 x model=3); the world has 4",
        ]


def test_shard_batch_pads_with_the_last_row():
    from relaxtpu.parallel.mesh import make_mesh as jax_make_mesh
    from relaxtpu.parallel.mesh import shard_batch as jax_shard_batch

    a = np.arange(13 * 4, dtype=np.float32).reshape(13, 4)
    want, real = jax_shard_batch(jax_make_mesh(n_data=8, n_model=1, platform="cpu"), a)
    want = np.asarray(want)
    for i in range(8):
        mesh = make_mesh(device="cpu")
        mesh = type(mesh)({"data": 8, "model": 1}, i, i, 0, None, None, mesh.device)
        got, got_t, n = shard_batch(mesh, a, torch.from_numpy(a))
        assert n == real == 13
        np.testing.assert_array_equal(got, want[2 * i : 2 * i + 2])
        np.testing.assert_array_equal(got_t.numpy(), got)


# ----------------------------------------------------- sharding, gathering
def test_shard_videos_matches_jax():
    from relaxtpu.parallel.distributed import shard_videos as jax_shard_videos

    items = [f"v{i}" for i in range(11)]
    for count in (1, 2, 3, 4):
        for index in range(count):
            assert shard_videos(items, index, count) == jax_shard_videos(items, index, count)
    assert shard_videos(items) == items  # a world of one


def test_allgather_video_features(two, four):
    """5 videos on 2 ranks, 5 and 2 (rank 2 empty) on 3 (a group of 3 of 4
    ranks): the whole matrix on every rank; without a process group, the
    identity scatter."""
    full2 = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    for res in two:
        np.testing.assert_array_equal(res["allgather_5"], full2)
    full3 = np.random.default_rng(1).normal(size=(5, 8)).astype(np.float32)
    for res in four[:3]:
        np.testing.assert_array_equal(res["allgather_5"], full3)
        np.testing.assert_array_equal(res["allgather_2"], full3[:2])
    got = allgather_video_features([2, 0], full2[[2, 0]], 3)
    np.testing.assert_array_equal(got, np.concatenate([full2[:1], np.zeros((1, 16), np.float32), full2[2:3]]))


# ---------------------------------------------------------- the evaluator
@pytest.fixture(scope="module")
def port_rows(models, clips):
    """The one-process single-video programs' rows of the three clips."""
    return one_process_rows(models["fx"], clips)


def test_sharded_run_equals_one_process(two, port_rows):
    """Every rank's rows are the one-process single-video programs' rows,
    bit for bit, and ``on_result`` fired for each rank's own videos in
    input order."""
    for rank, res in enumerate(two):
        for got, w in zip(res["run"], port_rows, strict=True):
            np.testing.assert_array_equal(got, w)
        assert res["run_seen"] == list(range(3))[rank::2]


def test_videos_batch_feature_i420_odd_count(two, port_rows, models, clips):
    """3 I420 videos on 2 ranks (padded with a copy of the last) through the
    batched program: on every rank, each row within the common bounds of
    its clip's single-video I420 row."""
    _, f, n, h, w = decode_clip(clips)((1, "i420"))
    want = [port_rows[0], models["fx"].video_feature_i420(f, n, h, w), port_rows[2]]
    for res in two:
        assert res["batch3"].shape == (3, DIM)
        for got, w in zip(res["batch3"], want, strict=True):
            assert_vectors_close(got, w)


@pytest.mark.parametrize("case", ["video_feature", "video_feature_one_frame"])
def test_video_feature_frame_sharded(two, models, clips, case):
    """One video's frames and pairs split over 2 ranks: within 1e-6
    relative of the one-process vector.  A one-frame clip (no pairs) has
    NaN in the same fragment entries as the one-process vector."""
    frames, nxt = clips["frames"][1], clips["nxt"][1]
    if case == "video_feature_one_frame":
        frames, nxt = frames[:1], nxt[:0]
    want = models["fx"].video_feature(frames, frames[: len(nxt)], nxt)
    nan = np.isnan(want)
    assert nan.sum() == (FRAG_RESNET_DIM + FRAG_VIT_DIM if len(nxt) == 0 else 0)
    for res in two:
        got = res[case]
        assert got.shape == (DIM,)
        np.testing.assert_array_equal(np.isnan(got), nan)
        assert np.abs(got[~nan] - want[~nan]).max() <= 1e-6 * np.abs(want[~nan]).max()


# ------------------------------------------------------- the DP x TP step
@pytest.fixture(scope="module")
def jax_dp(jax_head, groups):
    """JAX's 2 steps from its init."""
    import jax

    step, params, opt_state = jax_head["step"], jax_head["params"], jax_head["opt_state"]
    losses = []
    for _ in range(2):
        params, opt_state, loss = step.step(params, opt_state, jax_head["x"], jax_head["y"], jax.random.PRNGKey(1))
        losses.append(float(loss))
    return {"loss": losses, "params": jax.tree_util.tree_map(np.asarray, jax.device_get(params))}


@pytest.fixture(scope="module")
def dp_tp(jax_dp, four):
    """JAX's steps and the port's on 2 x 2 gloo ranks, from JAX's init."""
    return {**jax_dp, "ranks": four}


def test_dp_tp_step_matches_jax(dp_tp):
    from relaxtpu_torch.models.porters import mlp_from_jax

    params = dp_tp["params"]
    pad = params["fc1"]["kernel"][DIM:]
    assert pad.shape[0] == 1 and not pad.any()  # JAX's pad row, for reference
    params["fc1"]["kernel"] = params["fc1"]["kernel"][:DIM]
    want = mlp_from_jax({"params": params})
    for res in dp_tp["ranks"]:
        np.testing.assert_allclose(res["loss"], dp_tp["loss"], rtol=0, atol=1e-4)
        state = res["state"]
        for k, w in want.items():
            got = state[k][:, :DIM] if k == "fc1.weight" else state[k]
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_dp_tp_pad_row_stays_zero(dp_tp):
    for res in dp_tp["ranks"]:
        w1 = res["state"]["fc1.weight"]
        assert w1.shape == (HIDDEN, DIM + 1)
        assert not w1[:, DIM:].any()


def test_dropout_step_equals_one_process(two):
    """The 2 x 1 step with dropout 0.1: every rank draws the masks of the
    global batch, so 3 steps equal the one-process ``forward_train`` steps
    from the same generator."""
    for res in two:
        np.testing.assert_allclose(res["dropout_loss"], res["one_loss"], rtol=1e-5)
        for k, w in res["one_state"].items():
            np.testing.assert_allclose(res["dropout_state"][k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert two[0]["dropout_loss"] == two[1]["dropout_loss"]


def test_use_bn_refused_as_jax_fails():
    """JAX's class with use_bn=True keeps no batch_stats and its step
    raises; the port refuses it when built."""
    import jax
    from flax.errors import ScopeCollectionNotFound

    from relaxtpu.parallel.mesh import make_mesh as jax_make_mesh
    from relaxtpu.parallel.train_dp import DistributedMlpTrainStep as JaxStep

    step = JaxStep(jax_make_mesh(1, 1, platform="cpu"), input_dim=8, hidden=4, use_bn=True, drop_rate=0.0)
    params, opt_state = step.init(jax.random.PRNGKey(0))
    with pytest.raises(ScopeCollectionNotFound):
        step.step(params, opt_state, np.ones((2, 8), np.float32), np.ones(2, np.float32), jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="use_bn=True"):
        DistributedMlpTrainStep(make_mesh(device="cpu"), 8, hidden=4, use_bn=True)


# ------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def one_process(setup, models, groups):
    """The port's one-process ``extract`` runs (full and layer_stack)."""
    d = setup["dir"]
    with patched_cli(models["fx"]):
        run_cli(cli_args(setup, "--output", str(d / "one_out")))
        run_cli(cli_args(setup, "--output", str(d / "one_stack"), "--mode", "layer_stack"))
    return {"full": str(d / "one_out"), "stack": str(d / "one_stack")}


@pytest.fixture(scope="module")
def jax_cli_runs(setup, models, groups):
    """The JAX CLI's ``extract`` and ``predict-batch`` with ``--n-data 2``
    (its virtual CPU mesh) on the same mp4s."""
    import relaxtpu.cli.__main__ as jax_cli

    jp = models["jax"]
    saved = jax_cli._build_extractor, jax_cli._load_predictor
    jax_cli._build_extractor = lambda args: jp.extractor
    jax_cli._load_predictor = lambda args, extractor: jp
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            jax_cli.main(["extract", "--dataset", "konvid_1k", "--metadata-csv", setup["meta"], "--root",
                          setup["root"], "--output", str(setup["dir"] / "jax_out"), "--n-data", "2"])
            extract_line = out.getvalue().strip().splitlines()[-1]
            jax_cli.main(["predict-batch", "--videos", *setup["mp4s"], "--model", "m.npz", "--imputer", "i.pkl",
                          "--scaler", "s.pkl", "--n-data", "2"])
    finally:
        jax_cli._build_extractor, jax_cli._load_predictor = saved
    rows = [json.loads(line) for line in out.getvalue().strip().splitlines()[1:]]
    return {"extract_line": json.loads(extract_line), "store": str(setup["dir"] / "jax_out"), "rows": rows}


def test_cli_extract_sharded_equals_one_process(setup, one_process, two):
    """``extract --mode full --n-data 2``: rank 0 prints the JSON line and
    writes the store; store and .npy equal the one-process run's."""
    line = json.loads(two[0]["extract_stdout"].strip().splitlines()[-1])
    assert line == {"dataset": "konvid_1k", "mode": "full", "shape": [3, DIM], "mesh": {"data": 2, "model": 1}}
    assert two[1]["extract_stdout"] == ""
    mesh_store, one_store = FeatureStore(setup["mesh_out"]), FeatureStore(one_process["full"])
    for i in range(3):
        np.testing.assert_array_equal(mesh_store.get("konvid_1k", i), one_store.get("konvid_1k", i))
    np.testing.assert_array_equal(np.load(os.path.join(setup["mesh_out"], "konvid_1k_features.npy")),
                                  np.load(os.path.join(one_process["full"], "konvid_1k_features.npy")))
    assert [r["extract_calls"] for r in two] == [2, 1]  # each rank its round-robin share


def test_cli_extract_sharded_matches_jax_cli(setup, jax_cli_runs, two):
    from relaxtpu.data.store import FeatureStore as JaxStore

    assert jax_cli_runs["extract_line"] == json.loads(two[0]["extract_stdout"].strip().splitlines()[-1])
    for i in range(3):
        assert_vectors_close(FeatureStore(setup["mesh_out"]).get("konvid_1k", i),
                             JaxStore(jax_cli_runs["store"]).get("konvid_1k", i))


def test_cli_extract_sharded_resume_computes_nothing(setup, two):
    assert [r["resume_calls"] for r in two] == [0, 0]
    assert json.loads(two[0]["resume_stdout"]) == json.loads(two[0]["extract_stdout"])


def test_cli_extract_other_mode_runs_on_rank_0(setup, two, one_process):
    """A non-full mode warns on every rank, runs on rank 0 alone and
    stores what the one-process run stores."""
    assert [len(r["warnings"]) for r in two] == [1, 1]
    assert json.loads(two[0]["stack_stdout"])["shape"] == [3, 13120] and two[1]["stack_stdout"] == ""
    tag = "konvid_1k_layer_stack"
    for i in range(3):
        np.testing.assert_array_equal(FeatureStore(setup["stack_out"]).get(tag, i),
                                      FeatureStore(one_process["stack"]).get(tag, i))


def test_cli_extract_other_mode_outlives_the_group_timeout(groups):
    """A non-full mode whose run on rank 0 takes longer than the group's
    timeout: the other rank ends at once, with no collective to time out,
    and rank 0 ends when its run does."""
    res = groups["slow0"].results()
    assert [r["ran"] for r in res] == [["layer_stack"], []]
    assert res[0]["s"] >= SLOW_RANK0_S and res[1]["s"] < SHORT_TIMEOUT_S


def test_cli_predict_batch_sharded_matches_jax_cli(setup, two, jax_cli_runs):
    """``predict-batch --n-data 2``: rank 0 prints the rows in input order
    and writes the CSV; each MOS within 1e-4 of the JAX CLI's mesh run."""
    rows = [json.loads(line) for line in two[0]["predict_stdout"].splitlines()]
    assert [r["video"] for r in rows] == setup["mp4s"] and two[1]["predict_stdout"] == ""
    assert [r["video"] for r in jax_cli_runs["rows"]] == setup["mp4s"]
    for r, w in zip(rows, jax_cli_runs["rows"], strict=True):
        assert np.isfinite(r["predicted_mos"]) and abs(r["predicted_mos"] - w["predicted_mos"]) <= 1e-4, (r, w)
    assert os.path.exists(setup["csv"] + ".rank0") and not os.path.exists(setup["csv"] + ".rank1")


@pytest.mark.parametrize("cmd", ["extract", "predict-batch"])
def test_cli_mesh_without_process_group_raises(setup, models, monkeypatch, cmd):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    argv = cli_args(setup, "--n-data", "2") if cmd == "extract" else predict_args(setup, "--n-data", "2")
    with patched_cli(models["fx"], models["predictor"]), pytest.raises(RuntimeError, match="torchrun"):
        cli.main(argv)


def test_initialize_without_launcher_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize(device="cpu")


# ----------------------------------------------------------------- devices
def test_resolve_device_against_the_device_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="cuda:1: this host has 1 CUDA device$"):
        resolve_device("cuda:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)

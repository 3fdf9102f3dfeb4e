"""FAST-VQA on the port (``models/swin3d.py``, ``ops/window_attention.py``,
``features/fastvqa.py``, ``FastVQAPredictor``) against its plain float32
reference (``reference_fastvqa.py``) on seeded weights, on the CPU.

The JAX package has no FAST-VQA, so the reference is the plain PyTorch one,
written on the state dict alone with Video Swin's own constructions (the
explicit roll and partition, the meshgrid relative-position index, the
sliced shift mask, a rolled mini-patch id map); the port builds all of them
from token coordinates.  Small sizes keep every mechanism: 224 x 224
mosaics (stage grids 56, 28, 14 and 7 tokens a side), windows (2, 7, 7),
two blocks a stage (a shifted one each), the gate on stages 1-3 and a
time-only shift at stage 4.
"""

import math

import numpy as np
import pytest
import torch

from relaxtpu_torch import reference_fastvqa as ref
from relaxtpu_torch.features import fastvqa
from relaxtpu_torch.features.fastvqa import FastVQAExtractor
from relaxtpu_torch.models.swin3d import FastVQA, random_state
from relaxtpu_torch.ops import window_attention
from relaxtpu_torch.ops.colorspace import yuv420_to_bgr
from relaxtpu_torch.predict import FastVQAPredictor

SMALL = dict(depths=(2, 2, 2, 2), heads=(1, 2, 4, 8), embed_dim=32, window=(2, 7, 7))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_state():
    """Seeded weights with tables and biases large enough to matter."""
    sd = random_state(3, **SMALL)
    gen = torch.Generator().manual_seed(4)
    for k, v in sd.items():
        if k.endswith("bias_table") or k.endswith(".bias"):
            sd[k] = torch.randn(v.shape, generator=gen) * 0.5
    return sd


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _i420(n: int, h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h * w * 3 // 2), dtype=np.uint8)


def test_model_matches_reference(small_state):
    """The whole model (2 views of 8 x 224 x 224) against the reference."""
    model = FastVQA(**SMALL)
    model.load_state_dict(small_state)
    model.eval()
    mosaic = torch.randint(0, 256, (2, 8, 224, 224, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        scores, feat = model(mosaic)
    with ref.strict_f32(), torch.no_grad():
        want_s, want_f = ref.forward(small_state, mosaic, depths=SMALL["depths"], heads=SMALL["heads"],
                                     window=SMALL["window"])
    assert scores.shape == (2, 196) and feat.shape == (2, 256)
    assert _rel(scores, want_s) < 1e-5 and _rel(feat, want_f) < 1e-5
    # the gate, the mask and the tables all move the answer
    gateless = dict(small_state)
    for k in gateless:
        if k.endswith("fragment_position_bias_table"):
            gateless[k] = gateless[k.replace("fragment", "relative")]
    with ref.strict_f32(), torch.no_grad():
        other, _ = ref.forward(gateless, mosaic, depths=SMALL["depths"], heads=SMALL["heads"], window=SMALL["window"])
    assert _rel(other, want_s) > 1e-3


# FAST-VQA's stage geometries: (token grid, heads, mini-patch side in tokens); a head width of 4 keeps them cheap
STAGES = [((16, 56, 56), 1, 8), ((16, 28, 28), 2, 4), ((16, 14, 14), 2, 2), ((16, 7, 7), 2, 0)]


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("stage", range(4))
def test_window_mha_plain_matches_reference(stage, shifted):
    """Index arithmetic only: the port's windows, index, gate and mask from
    token coordinates against the reference's roll, partition, meshgrid
    index, sliced mask and rolled id map, at each stage's geometry."""
    grid, heads, patch = STAGES[stage]
    window, shift = window_attention.effective_window(grid, (8, 7, 7), (4, 3, 3) if shifted else (0, 0, 0))
    assert shift == ((4, 3, 3) if shifted and stage < 3 else (4, 0, 0) if shifted else (0, 0, 0))
    gen = torch.Generator().manual_seed(stage)
    qkv = torch.randn((1, math.prod(grid), 3 * heads * 4), generator=gen)
    tables = [torch.randn((2535, heads), generator=gen) for _ in range(1 + bool(patch))]
    got = window_attention.window_mha(qkv, grid, window, shift, heads, tables, patch, 0.5)
    want = ref.window_attention(qkv.view(1, *grid, -1), heads, window, shift, tables, patch, 0.5)
    assert torch.allclose(got.view_as(want), want, atol=2e-5, rtol=1e-5)


def test_k4_launch_passes_only_scalars_and_the_tables(monkeypatch):
    """K4's path allocates its output and nothing else (no N x N bias, gate
    or mask, no window copy), and hands the kernel qkv, the two (2535,
    heads) tables, the output and scalars."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls, ops = [], []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ops.append((str(func), tuple(out.shape) if isinstance(out, torch.Tensor) else None))
            return out

    monkeypatch.setattr(window_attention._native, "check_cuda_input", lambda *a: None)
    monkeypatch.setattr(window_attention._native, "launch_here", lambda *a: calls.append(a))
    grid, heads = (16, 56, 56), 3
    qkv = torch.zeros((4, math.prod(grid), 3 * heads * 32), dtype=torch.bfloat16)
    tables = [torch.zeros((2535, heads)), torch.ones((2535, heads))]
    n0 = window_attention.window_mha.launches
    with Ops():
        out = window_attention._launch(qkv, grid, (8, 7, 7), (4, 3, 3), heads, tables, 8, 32**-0.5)
    assert [o for o in ops if "new_empty" not in o[0] and "empty" not in o[0]] == []
    assert [o[1] for o in ops] == [(4, math.prod(grid), heads * 32)]
    (args,) = calls
    assert args[0] == "relax_window_mha_bf16"
    assert args[2:6] == (qkv.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), out.data_ptr())
    assert args[6:] == (4, 16, 56, 56, 8, 7, 7, 4, 3, 3, heads, 8, 32**-0.5)
    assert all(type(a) in (int, float) for a in args[2:])
    assert window_attention.window_mha.launches == n0 + 1
    with pytest.raises(ValueError, match="whole windows"):
        window_attention._launch(qkv, (16, 56, 55), (8, 7, 7), (0, 0, 0), heads, tables[:1], 0, 1.0)
    with pytest.raises(ValueError, match="two tables"):
        window_attention._launch(qkv, grid, (8, 7, 7), (0, 0, 0), heads, tables[:1], 8, 1.0)


def test_clip_sampling_and_offsets():
    """FAST-VQA's test-time clips of a 192-frame KoNViD-1k video, and the
    offsets' range at 960x540."""
    idx = fastvqa.clip_indices(192)
    assert [c[0] for c in idx] == [16, 48, 80, 112] and all(c[1] - c[0] == 2 and len(c) == 32 for c in idx)
    assert len({i for c in idx for i in c}) == 80
    assert idx == ref.sample_clips(192)
    assert fastvqa.offset_range(540, 960) == (45, 105)
    off = fastvqa.draw_offsets(np.random.default_rng(1), 540, 960)
    assert off.shape == (4, 7, 7, 2) and off[..., 0].max() < 45 and off[..., 1].max() < 105
    with pytest.raises(ValueError, match="offsets"):
        fastvqa.region_plan(540, 960, off + np.array([45, 0]))


@pytest.mark.parametrize("h, w", [(540, 960), (246, 238), (226, 254)])
def test_mosaic_is_convert_then_crop(h, w):
    """The program's mosaic (regions cut on the host, converted, cropped on
    the device) equals whole frames converted by ``yuv420_to_bgr``, cropped
    by FAST-VQA's grid and flipped to RGB, bit for bit, with odd and even
    offsets; the reference's whole-frame path gives the same."""
    rows, cols = fastvqa.offset_range(h, w)
    rng = np.random.default_rng(h)
    off = fastvqa.draw_offsets(rng, h, w, clips=2)
    if rows > 1:
        off[0, :, :, 0] = np.arange(49).reshape(7, 7) % rows  # odd and even rows
    if cols > 1:
        off[1, :, :, 1] = (np.arange(49).reshape(7, 7) * 3) % cols
    off[0, 6, 6] = (max(rows - 1, 0), max(cols - 1, 0))  # the bottom-right corner at its largest offset
    clips = [_i420(3, h, w, seed) for seed in (1, 2)]
    fx = FastVQAExtractor(random_state(0, **SMALL), torch.float32, "cpu", **SMALL)
    got = fx.mosaic_i420(clips, h, w, off)
    want = []
    for clip, o in zip(clips, off):
        t = torch.from_numpy(clip)
        bgr = yuv420_to_bgr(t[:, : h * w].view(-1, h, w), t[:, h * w: h * w * 5 // 4].view(-1, h // 2, w // 2),
                            t[:, h * w * 5 // 4:].view(-1, h // 2, w // 2))
        want.append(ref.fragments(bgr.flip(-1), o))
    assert got.shape == (2, 3, 224, 224, 3) and got.dtype == torch.uint8
    assert torch.equal(got, torch.stack(want))
    assert torch.equal(got, ref.Reference({}, "cpu").mosaic(clips, h, w, off))


def test_program_and_predictor_on_the_cpu(small_state, tmp_path):
    """The serving program's answer against the reference's on the same
    clips and offsets; the predictor's routes (I420 from a raw .yuv file,
    BGR arrays) give the same score for the same offsets."""
    h, w, n = 228, 254, 20  # the host converter of a .yuv frame reads chroma by rows: H a multiple of 4
    frames = _i420(n, h, w, 7)
    idx = fastvqa.clip_indices(n, clip_len=4, interval=2)
    clips = [frames[c] for c in idx]
    off = fastvqa.draw_offsets(np.random.default_rng(3), h, w)
    fx = FastVQAExtractor(small_state, torch.float32, "cpu", **SMALL)
    vec, score = fx.finish(fx.enqueue_i420(clips, h, w, off))
    r = ref.Reference(small_state, "cpu", **{k: SMALL[k] for k in ("depths", "heads", "window")})
    scores, feats, want = r.answer(clips, h, w, off)
    assert vec.shape == (scores.size + feats.size,)
    assert _rel(vec[:scores.size], scores.reshape(-1)) < 1e-5 and _rel(vec[scores.size:], feats.reshape(-1)) < 1e-5
    assert score == pytest.approx(want, abs=1e-5)

    path = tmp_path / "clip.yuv"
    frames.tofile(path)
    a = FastVQAPredictor(fx, seed=11, clip_len=4).predict_file(str(path), width=w, height=h)
    from relaxtpu_torch.io.video import _yuv420_to_bgr_limited

    bgr = np.stack([_yuv420_to_bgr_limited(f.reshape(h * 3 // 2, w), w, h) for f in frames])
    b = FastVQAPredictor(fx, seed=11, clip_len=4).predict_arrays(bgr)
    assert math.isfinite(a) and a == pytest.approx(b, abs=1e-5)


def test_pending_videos_launch_in_order(monkeypatch, small_state):
    """The card's path, with the eager stages in the CUDA graphs' place: a
    video's program is launched by the next enqueue (its regions cut
    meanwhile) or by its own finish; answers equal the eager program's; a
    video's failure is raised at its own finish and the next video goes on."""
    class EagerGraphs:
        def __init__(self, fx, views, t):
            self.fx = fx
            self.regions = torch.zeros((views, t, fastvqa.PATCHES, fastvqa.REGION_BYTES), dtype=torch.uint8)
            self.shifts = torch.zeros((views, fastvqa.PATCHES), dtype=torch.int64)

        def run(self):
            return self.fx._score(self.fx._mosaic(self.fx._colorspace(self.regions), self.shifts))

    h, w = 228, 254
    frames = [_i420(4, h, w, seed) for seed in (8, 9)]
    offs = [fastvqa.draw_offsets(np.random.default_rng(s), h, w, clips=2) for s in (1, 2)]
    fx = FastVQAExtractor(small_state, torch.float32, "cpu", **SMALL)
    want = [fx.finish(fx.enqueue_i420([f, f[::-1].copy()], h, w, o))[0] for f, o in zip(frames, offs)]
    monkeypatch.setattr(fastvqa, "GraphedProgram", EagerGraphs)
    fx.graphs = True
    a = fx.enqueue_i420([frames[0], frames[0][::-1].copy()], h, w, offs[0])
    assert a.answer is None
    b = fx.enqueue_i420([frames[1], frames[1][::-1].copy()], h, w, offs[1])
    assert a.answer is not None and b.answer is None
    assert np.array_equal(fx.finish(b)[0], want[1]) and np.array_equal(fx.finish(a)[0], want[0])
    bad = fx.enqueue_i420([frames[0][:, :10], frames[0][:, :10]], h, w, offs[0])  # frames of the wrong size
    c = fx.enqueue_i420([frames[1], frames[1][::-1].copy()], h, w, offs[1])
    with pytest.raises(ValueError, match="packed I420"):
        fx.finish(bad)
    assert np.array_equal(fx.finish(c)[0], want[1])


def test_cli_fastvqa_raises_without_cuda(monkeypatch):
    from relaxtpu_torch.cli.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["predict", "--video", "x.yuv", "--arch", "fastvqa", "--weights", "w.pth"])
    with pytest.raises(SystemExit, match="--model"):
        main(["predict", "--video", "x.yuv"])


@pytest.mark.slow
def test_full_size_forward():
    """FAST-B at its published widths (one view of 32 x 224 x 224) against
    the reference."""
    sd = random_state(1)
    model = FastVQA()
    model.load_state_dict(sd)
    model.eval()
    mosaic = torch.randint(0, 256, (1, 32, 224, 224, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        scores, feat = model(mosaic)
    with ref.strict_f32(), torch.no_grad():
        want_s, want_f = ref.forward(sd, mosaic)
    assert scores.shape == (1, 784) and feat.shape == (1, 768)
    assert _rel(scores, want_s) < 1e-4 and _rel(feat, want_f) < 1e-4

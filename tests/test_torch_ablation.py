"""The port's extraction modes against the JAX package's.

Each ablation mode of ``relaxtpu_torch.cli.__main__._extract_one`` (raw
I420 buffers in, the stored per-frame or per-pair matrix out) against
``relaxtpu.cli.__main__._extract_one`` on the BGR frames that the port's
host converter gives for the same buffers; also the extractor's public
``frame_features`` / ``pair_features``.  Small size: 2 frames or 2 pairs at
120x160, or two smoothly translating 224x272 pairs for the ``_frag`` modes
(238 patches, so the top-196 selection has work to do), a depth-2 ViT, f32.

Bounds, per row: cosine >= 0.99999 and mean |error| / mean |JAX| <= 1e-4,
the pipeline test's.  Measured (seeds 1 and 5): the lowest row cosine is
0.9999999995 (optical_flow, vit); the largest mean relative errors are
1.1e-5 (optical_flow, vit), 7.8e-6 (layer_stack), 4.9e-6 (fragment_pool)
and 1.2e-6 (optical_flow_frag), the rest at or below 4.9e-7.  On the
smooth pairs the flow images differ from JAX's by one value LSB on 0.012%
of pixels; no fragment near-tie flips, so optical_flow_frag keeps the
common bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from relaxtpu.cli.__main__ import _extract_one as jax_extract_one
from relaxtpu.features.ablation import AblationExtractor as JaxAblation
from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu_torch.cli.__main__ import _extract_one
from relaxtpu_torch.features.ablation import AblationExtractor
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io.video import _yuv420_to_bgr_limited
from relaxtpu_torch.models.porters import resnet50_from_jax, vit_from_jax

H, W = 120, 160


def assert_rows_close(ours: np.ndarray, theirs: np.ndarray, shape: tuple) -> None:
    assert ours.shape == theirs.shape == shape
    assert np.isfinite(ours).all()
    for a, b in zip(ours.astype(np.float64), theirs.astype(np.float64)):
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        rel = np.abs(a - b).mean() / np.abs(b).mean()
        assert cos >= 0.99999 and rel <= 1e-4, (cos, rel)


@pytest.fixture(scope="module")
def extractors():
    rn = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    vit = port_torch_vit(build_torch_vit(depth=2, seed=1).state_dict(), depth=2)
    jfx = JaxExtractor(rn, vit, dtype=jnp.float32, vit_depth=2)
    tfx = FeatureExtractor(resnet50_from_jax(rn), vit_from_jax(vit, depth=2),
                           dtype=torch.float32, vit_depth=2, device="cpu")
    return (jfx, JaxAblation(jfx)), (tfx, AblationExtractor(tfx))


def as_i420(prev_bgr: np.ndarray, nxt_bgr: np.ndarray) -> dict:
    """Packed I420 buffers for the port and, for JAX, the BGR frames the
    port's host converter gives for them."""
    fbuf, nbuf = (pack_i420(*bgr_to_yuv420(x)) for x in (prev_bgr, nxt_bgr))
    h, w = prev_bgr.shape[1:3]

    def host_bgr(buf):
        return np.stack([_yuv420_to_bgr_limited(f.reshape(h * 3 // 2, w), w, h) for f in buf])

    frames = host_bgr(fbuf)
    return {"fbuf": fbuf, "nbuf": nbuf, "h": h, "w": w,
            "frames": frames, "prev": frames, "nxt": host_bgr(nbuf)}


def smooth_pair(rng, h=224, w=272, shift=3):
    """A translating textured pair (realistic flow, unlike iid noise)."""
    base = ndi.gaussian_filter(rng.integers(0, 256, (h + 16, w + 16, 3)).astype(np.float64), (3, 3, 0))
    return base[:h, :w].astype(np.uint8), base[shift : h + shift, shift : w + shift].astype(np.uint8)


@pytest.fixture(scope="module")
def small():
    return as_i420(*synthetic_correlated_video(np.random.default_rng(1), 2, H, W))


@pytest.fixture(scope="module")
def smooth():
    rng = np.random.default_rng(5)
    pairs = [smooth_pair(rng, shift=s) for s in (3, 2)]
    return as_i420(np.stack([p for p, _ in pairs]), np.stack([n for _, n in pairs]))


@pytest.fixture(scope="module")
def jax_pair_features(extractors, small):
    return extractors[0][0].pair_features(small["prev"], small["nxt"])


@pytest.mark.parametrize("mode,network,layer,inputs,dim", [
    ("frame_diff", "resnet50", "pool", "small", 2051),
    ("frame_diff_frag", "resnet50", "last_layer", "smooth", 2048),
    ("optical_flow", "vit", "pool", "small", 2304),
    ("optical_flow_frag", "resnet50", "layer_stack", "smooth", 13120),
    ("layer", "resnet50", "pool", "small", 2051),  # the frames resized, not quantised
    ("layer_stack", "resnet50", "pool", "small", 13120),  # frame_features: quantised
])
def test_mode_matches_jax(extractors, request, mode, network, layer, inputs, dim):
    (jfx, jabl), (tfx, tabl) = extractors
    x = request.getfixturevalue(inputs)
    got = _extract_one(tfx, tabl, mode, network, layer, "i420", (x["fbuf"], x["nbuf"], x["h"], x["w"]))
    want = jax_extract_one(jfx, jabl, mode, network, layer, x["frames"], x["prev"], x["nxt"])
    assert_rows_close(got.numpy(), np.asarray(want), (2, dim))


@pytest.mark.parametrize("mode,index,dim", [("fragment_layerstack", 0, 15171), ("fragment_pool", 1, 4608)])
def test_fragment_mode_matches_jax(extractors, small, jax_pair_features, mode, index, dim):
    """One JAX ``pair_features`` call serves both modes; the port runs only
    the network whose rows the mode stores."""
    _, (tfx, tabl) = extractors
    got = _extract_one(tfx, tabl, mode, "resnet50", "pool", "i420", (small["fbuf"], small["nbuf"], H, W))
    assert_rows_close(got.numpy(), jax_pair_features[index], (2, dim))


def test_public_frame_and_pair_features(extractors, small, jax_pair_features):
    """``frame_features`` / ``pair_features`` on host BGR, both networks."""
    (jfx, _), (tfx, _) = extractors
    for ours, theirs, dim in zip(tfx.frame_features(small["frames"]), jfx.frame_features(small["frames"]),
                                 (13120, 2304)):
        assert_rows_close(ours, theirs, (2, dim))
    for ours, theirs, dim in zip(tfx.pair_features(small["prev"], small["nxt"]), jax_pair_features,
                                 (15171, 4608)):
        assert_rows_close(ours, theirs, (2, dim))


def test_pair_features_chunks(extractors, small, monkeypatch):
    """More pairs than ``max_pair_batch``: the chunks give the rows of one
    batch, and the ablation API's numpy form equals the device form."""
    _, (tfx, tabl) = extractors
    whole = tfx.pair_features(small["prev"], small["nxt"])
    monkeypatch.setattr(FeatureExtractor, "max_pair_batch", lambda self, h, w: 1)
    for a, b in zip(tfx.pair_features(small["prev"], small["nxt"]), whole):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    chunked = _extract_one(tfx, tabl, "frame_diff", "vit", "pool", "i420", (small["fbuf"], small["nbuf"], H, W))
    np.testing.assert_allclose(chunked.numpy(),
                               tabl.pair_features("frame_diff", "vit", "pool", small["prev"], small["nxt"]),
                               rtol=1e-5, atol=1e-5)


def test_ablation_refuses_unknown_modes(extractors, small):
    _, (_, tabl) = extractors
    for mode, network, layer in (("merged_frag", "vit", "pool"), ("frame_diff", "vgg", "pool"),
                                 ("frame_diff", "resnet50", "fc2")):
        with pytest.raises(ValueError):
            tabl.pair_features(mode, network, layer, small["prev"], small["nxt"])

"""``visualize`` and what it runs, the port against the JAX package on the
same numpy inputs and weights (CPU, f32).

- ``fragment_pair``: bit-equal.
- Cubic ``weight_matrix``: bit-equal to jax's ``compute_weight_mat``
  evaluated op by op; against ``jax.image.resize(..., "bicubic")``, whose
  jitted program XLA compiles with its own float rounding (the weights of
  the jitted program differ from the op-by-op ones by up to 1.4e-6 at
  14 -> 16), within 2.5e-6 of the input's largest magnitude (measured
  1.98e-6 at 14x14 -> 14x16, 1.58e-6 at 16x16, 1.8e-7 to 5.0e-7 at the
  others): a bound of 1e-6 would sit below that rounding.
- The depth-2 ViT's patch tokens at 224x224, 160x192, 256x256 and 384x384
  (577 tokens; JAX's ViT there through ``fused_mha`` in interpret mode):
  within 1e-5 of the largest token magnitude (measured 8.5e-7 to 9.1e-7); the
  last block's attention matrix against
  ``relaxtpu.visualize.last_selfattention``: within 1e-5 (measured 1.1e-8).
- ``visualize`` through both CLIs on the same PNGs (a 224x320 pair, depth-2
  ViT): the same fragment positions; the overlays differ by at most 2 LSB
  on at most 1% of values (measured: bit-equal).

Weights: the torch oracle's (``relaxtpu.oracle.build_torch_vit``) into JAX
through relaxtpu's porters and into the port as they are.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

import relaxtpu.cli.__main__ as jax_cli
import relaxtpu.visualize as jvis
from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.models.vit import ViT as JaxViT
from relaxtpu.ops import fragment_pair as jax_fragment_pair
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit
from relaxtpu_torch import visualize as tvis
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.ops.fragments import fragment_pair
from relaxtpu_torch.ops.resize import resize_hw, weight_matrix

DEPTH = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vit_state():
    return build_torch_vit(depth=DEPTH, seed=1).state_dict()


@pytest.fixture(scope="module")
def vits(vit_state):
    tvit = ViT(depth=DEPTH)
    tvit.load_state_dict(vit_state)
    return tvit.eval(), JaxViT(depth=DEPTH), port_torch_vit(vit_state, depth=DEPTH)


def smooth_pair(seed: int, h: int, w: int):
    """A blurred random texture and the same texture shifted by (2, 3) px
    plus noise: motion makes the residual's patch scores distinct."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 256, (h + 8, w + 8, 3), dtype=np.uint8), (0, 0), 2)
    prev = base[4 : 4 + h, 4 : 4 + w]
    nxt = np.clip(base[2 : 2 + h, 1 : 1 + w] + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(prev), nxt


def test_fragment_pair_bit_equal(rng):
    """Residuals with distinct scores and with ties (flat 16x16 blocks)."""
    res = rng.integers(0, 256, (3, 120, 160, 3), dtype=np.uint8)
    res[1] = np.kron(rng.integers(0, 4, (8, 10, 1)), np.ones((15, 16, 3))).astype(np.uint8)
    ori = rng.integers(0, 256, (3, 120, 160, 3), dtype=np.uint8)
    got_res, got_ori = fragment_pair(torch.from_numpy(res), torch.from_numpy(ori))
    for i in range(3):
        want_res, want_ori = jax_fragment_pair(jnp.asarray(res[i]), jnp.asarray(ori[i]))
        np.testing.assert_array_equal(got_res[i].numpy(), np.asarray(want_res))
        np.testing.assert_array_equal(got_ori[i].numpy(), np.asarray(want_ori))


@pytest.mark.parametrize("n_in, out", [(14, (10, 12)), (14, (16, 16)), (14, (7, 9)), (14, (20, 24)),
                                        (14, (14, 16))])
def test_cubic_weights_equal_jax(n_in, out):
    """Down- and upsampling of a 14x14 grid, the ViT's position table."""
    for n_out in out:
        want = np.asarray(jax_scale.compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0.0),
                                                       jax_scale._fill_keys_cubic_kernel, True)).T
        np.testing.assert_array_equal(weight_matrix(n_in, n_out, "bicubic", True), want)
    x = np.random.default_rng(n_in + out[0]).normal(size=(1, n_in, n_in, 64)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *out, 64), "bicubic"))[0]
    got = resize_hw(torch.from_numpy(x[0]).permute(2, 0, 1), out, "bicubic", antialias=True).permute(1, 2, 0)
    assert np.abs(got.numpy() - want).max() <= 2.5e-6 * np.abs(x).max()


@pytest.mark.parametrize("hw", [(224, 224), (160, 192), (256, 256), (384, 384)])
def test_vit_tokens_equal_jax(vits, hw):
    """224x224 keeps the position table; 160x192 (10 x 12 patches), 256x256
    (16 x 16) and 384x384 (24 x 24) resize it bicubically.  At 384x384 (577
    tokens, past K3's short entries) JAX's ViT runs its Pallas attention."""
    tvit, jvit, jvars = vits
    if hw == (384, 384):
        jvit = JaxViT(depth=DEPTH, fused_attention=True)
    x = np.random.default_rng(sum(hw)).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jvit.apply(jvars, jnp.asarray(x), reduce=None))
    with torch.inference_mode():
        got = tvit.tokens(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, (hw[0] // 16) * (hw[1] // 16), 768)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_interpolate_pos_embed_equals_jax(vits):
    tvit, jvit, jvars = vits
    pos = jvars["params"]["pos_embed"]
    for hp, wp in ((14, 14), (10, 12), (16, 16)):
        want = np.asarray(jvit.apply(jvars, jnp.asarray(pos), hp, wp, method=JaxViT.interpolate_pos_embed))
        with torch.inference_mode():
            got = tvit.interpolate_pos_embed(hp, wp).numpy()
        assert got.shape == want.shape == (1, hp * wp + 1, 768)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_last_attention_equals_jax(vits):
    tvit, jvit, jvars = vits
    img = np.random.default_rng(3).uniform(0, 1, (224, 224, 3))
    want = jvis.last_selfattention(jvit, jvars, img)
    got = tvis.last_selfattention(tvit, img)
    assert got.shape == want.shape == (12, 197, 197)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_allclose(tvis.cls_patch_attention(got), jvis.cls_patch_attention(want), atol=1e-6)


def test_fragment_positions_equal_jax():
    prev, nxt = smooth_pair(4, 224, 320)
    residual = np.abs(prev.astype(np.int32) - nxt.astype(np.int32)).astype(np.uint8)
    got = tvis.fragment_positions(residual, device="cpu")
    assert got == jvis.fragment_positions(residual)
    assert len(got) == 196 and got == sorted(got)


def test_visualize_cli_equals_jax(tmp_path, monkeypatch, vit_state, capsys):
    """Both CLIs on the same PNGs with the same depth-2 ViT: positions
    (spied) identical, overlays within 2 LSB on at most 1% of values."""
    rn_state = build_torch_resnet50(seed=0).state_dict()
    jfx = JaxExtractor(port_torch_resnet50(rn_state), port_torch_vit(vit_state, depth=DEPTH),
                       dtype=jnp.float32, vit_depth=DEPTH)
    tfx = FeatureExtractor(rn_state, vit_state, dtype=torch.float32, vit_depth=DEPTH, device="cpu")
    monkeypatch.setattr(jax_cli, "_build_extractor", lambda args: jfx)
    monkeypatch.setattr(cli, "_build_extractor", lambda args: tfx)
    seen = {}
    for name, mod in (("jax", jvis), ("torch", tvis)):
        real = mod.fragment_positions

        def spy(*a, _real=real, _name=name, **k):
            seen[_name] = _real(*a, **k)
            return seen[_name]

        monkeypatch.setattr(mod, "fragment_positions", spy)
    prev, nxt = smooth_pair(5, 224, 320)
    f0, f1 = str(tmp_path / "f0.png"), str(tmp_path / "f1.png")
    cv2.imwrite(f0, prev)
    cv2.imwrite(f1, nxt)
    flags = ["--frame", f0, "--next-frame", f1]
    jax_cli.main(["visualize", *flags, "--output", str(tmp_path / "jax")])
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(["visualize", *flags, "--output", str(tmp_path / "torch"), "--device", "cpu", "--f32"])
    got_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got_line == {"overlay": os.path.join(str(tmp_path / "torch"), "attention_overlay.png"),
                        "n_patches": 196}
    assert got_line["n_patches"] == want_line["n_patches"]
    assert seen["torch"] == seen["jax"]
    got, want = cv2.imread(got_line["overlay"]), cv2.imread(want_line["overlay"])
    assert got.shape == want.shape == prev.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())

"""Backbones of the port against the JAX package in f32 at 224x224, with the
torch oracle weights carried JAX -> port by ``relaxtpu_torch.models.porters``
(so the porters run on non-trivial weights).  Bound: every ResNet tap and
the ViT stats within 1e-4 of the JAX result, relative to its largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.model.mlp import port_torch_mlp
from relaxtpu.models import ResNet50 as JaxResNet50
from relaxtpu.models import ViT as JaxViT
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.models.resnet import resnet_preprocess as jax_preprocess
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit
from relaxtpu_torch.model.mlp import Mlp
from relaxtpu_torch.models.porters import mlp_from_jax, resnet50_from_jax, vit_from_jax
from relaxtpu_torch.models.resnet import RESNET_TAPS, ResNet50, resnet_preprocess
from relaxtpu_torch.models.vit import ViT


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).random((2, 224, 224, 3)).astype(np.float32)


def test_resnet_taps_match_jax(images):
    jvars = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    want = JaxResNet50().apply(jvars, jax_preprocess(jnp.asarray(images)), reduce="mean")
    net = ResNet50().eval()
    net.load_state_dict(resnet50_from_jax(jvars))
    x = resnet_preprocess(torch.from_numpy(images).permute(0, 3, 1, 2))
    with torch.no_grad():
        got = net(x)
    for name in (*RESNET_TAPS, "avgpool"):
        assert got[name].shape == want[name].shape, name
        assert rel(got[name].numpy(), np.asarray(want[name])) <= 1e-4, name


def _vit_stats(images, depth):
    jparams = port_torch_vit(build_torch_vit(depth=depth, seed=1).state_dict(), depth=depth)
    want = np.asarray(JaxViT(depth=depth).apply(jparams, jnp.asarray(images), reduce="stats"))
    net = ViT(depth=depth).eval()
    net.load_state_dict(vit_from_jax(jparams, depth=depth))
    with torch.no_grad():
        got = net(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    return got, want


def test_vit_stats_match_jax_depth2(images):
    got, want = _vit_stats(images, 2)
    assert got.shape == want.shape == (2, 3 * 768)
    assert rel(got, want) <= 1e-4


@pytest.mark.slow
def test_vit_stats_match_jax_depth12(images):
    got, want = _vit_stats(images, 12)
    assert rel(got, want) <= 1e-4


def test_porters_invert_relaxtpu_porters():
    """resnet50_from_jax / mlp_from_jax undo relaxtpu's torch -> Flax porters
    exactly, key for key."""
    sd = build_torch_resnet50(seed=0).state_dict()
    back = resnet50_from_jax(port_torch_resnet50(sd))
    assert set(back) == {k for k in ResNet50().state_dict() if not k.endswith("num_batches_tracked")}
    for key, val in back.items():
        torch.testing.assert_close(val, sd[key], rtol=0, atol=0)

    mlp = Mlp()
    mlp_sd = {k: torch.randn(v.shape) for k, v in mlp.state_dict().items() if "num_batches" not in k}
    swa = {f"module.{k}": v for k, v in mlp_sd.items()} | {"n_averaged": torch.tensor(3)}
    back = mlp_from_jax(port_torch_mlp(swa))
    assert set(back) == set(mlp_sd)
    for key, val in back.items():
        torch.testing.assert_close(val, mlp_sd[key], rtol=0, atol=0)

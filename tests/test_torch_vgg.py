"""The port's VGG-16 against ``relaxtpu.models.vgg.VGG16``.

Seeded weights in the torchvision layout (the port's own module after
``random_init_``) go into JAX with relaxtpu's ``port_torch_vgg16`` and
back with ``relaxtpu_torch.models.porters.vgg16_from_jax``.  Batch 1 at
224x224, f32: every raw conv tap and ``fc2`` within 1e-4 of the tap's
largest magnitude (measured: 1.3e-6 at most on the taps, 2.6e-6 on fc2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.models.vgg import VGG16 as JaxVGG16
from relaxtpu.models.vgg import VGG_TAPS as JAX_TAPS
from relaxtpu.models.vgg import port_torch_vgg16
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.porters import vgg16_from_jax
from relaxtpu_torch.models.vgg import VGG16, VGG_CONV_INDICES, VGG_STACK_DIM, VGG_TAPS


@pytest.fixture(scope="module")
def weights():
    """(torchvision-layout state dict, the JAX variables made from it)."""
    sd = random_init_(VGG16(), 0).state_dict()
    return sd, port_torch_vgg16(sd)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(2).normal(0, 1, (1, 3, 224, 224)).astype(np.float32)


def test_layout_and_round_trip(weights):
    sd, variables = weights
    assert VGG_TAPS == JAX_TAPS
    assert VGG_STACK_DIM == sum(sd[f"features.{i}.bias"].numel() for i in VGG_CONV_INDICES)
    assert set(sd) == {f"{p}.{i}.{k}" for p, idx in (("features", VGG_CONV_INDICES), ("classifier", (0, 3)))
                       for i in idx for k in ("weight", "bias")}
    back = vgg16_from_jax(variables)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_taps_match_jax(weights, image):
    sd, variables = weights
    model = VGG16()
    model.load_state_dict(vgg16_from_jax(variables))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(image), reduce=None)
        means = model(torch.from_numpy(image))
    want = JaxVGG16().apply(variables, jnp.asarray(image.transpose(0, 2, 3, 1)), reduce=None)
    assert set(got) == set(means) == set(VGG_TAPS) | {"fc2"}
    for name in VGG_TAPS:
        w = np.asarray(want[name]).transpose(0, 3, 1, 2)
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(got[name].numpy() - w).max() / scale <= 1e-4, name
        np.testing.assert_allclose(means[name].numpy(), got[name].numpy().mean(axis=(2, 3)),
                                   rtol=1e-5, atol=1e-6 * scale)
    w = np.asarray(want["fc2"])
    assert got["fc2"].shape == (1, 4096) and got["fc2"].dtype == torch.float32
    assert np.abs(got["fc2"].numpy() - w).max() / np.abs(w).max() <= 1e-4

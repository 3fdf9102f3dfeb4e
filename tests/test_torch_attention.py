"""K3's plain version (``mha`` on CPU tensors) against the Pallas kernel
``fused_mha`` in interpret mode, at the shapes and tolerances of
tests/test_attention_kernel.py, in f32 and bf16, and past the short entries'
domain (N > 256, head dims other than 32 and 64), where ``fused_mha`` pads N
to a multiple of 128 and the port takes the long entries.  The routing
(``_plan``) and the staging of layouts (``_staged``) are pure Python and run
here; the kernels themselves are held against this plain version on the
card by chip_smoke.py (with every input at the start of a NaN-filled
allocation, so a read out of bounds shows)."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.ops.attention import fused_mha
from relaxtpu_torch.ops import attention
from relaxtpu_torch.ops.attention import mha


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rng():
    """This file's own generator (the session one's state depends on which
    files ran before in the same worker): the inputs are those of a run of
    this file alone."""
    return np.random.default_rng(0)


def _run(q, k, v, dtype_j, dtype_t, scale):
    with jax.default_device(jax.devices("cpu")[0]):
        want = fused_mha(*(jnp.asarray(a, dtype_j) for a in (q, k, v)), scale=scale, interpret=True)
    got = mha(*(torch.from_numpy(a).to(dtype_t) for a in (q, k, v)), scale=scale)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("b,n,h,d", [(2, 197, 12, 64), (1, 17, 4, 32), (3, 128, 2, 64),
                                     (1, 1, 2, 64), (2, 256, 2, 32), (1, 208, 3, 64),
                                     # past the short entries: N > 256 and head dims other than 32 and 64
                                     (2, 257, 2, 80), (2, 257, 2, 128), (2, 577, 2, 80), (2, 577, 2, 128)])
def test_mha_plain_matches_pallas_f32(rng, b, n, h, d):
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    want, got = _run(q, k, v, jnp.float32, torch.float32, d**-0.5)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert mha.launches == 0  # CPU tensors never reach the kernel


def test_mha_plain_matches_pallas_bf16(rng):
    b, n, h, d = 2, 197, 12, 64
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    want, got = _run(q, k, v, jnp.bfloat16, torch.bfloat16, d**-0.5)
    np.testing.assert_allclose(got, want, atol=2e-2)
    cos = np.dot(want.ravel(), got.ravel()) / (np.linalg.norm(want) * np.linalg.norm(got))
    assert cos > 0.99999


def test_mha_packed_qkv_slices_match_contiguous(rng):
    """The ViT hands over column slices of one packed qkv projection."""
    b, n, h, d = 2, 197, 4, 64
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    q, k, v = (qkv[..., i * h * d : (i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
    got = mha(q, k, v, d**-0.5)
    want = mha(q.contiguous(), k.contiguous(), v.contiguous(), d**-0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mha_plain_matches_pallas_long_rows_bf16(rng):
    """ViT-B/16 at 384x384: 577 tokens, D = 64."""
    b, n, h, d = 2, 577, 2, 64
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    want, got = _run(q, k, v, jnp.bfloat16, torch.bfloat16, d**-0.5)
    np.testing.assert_allclose(got, want, atol=2e-2)
    cos = np.dot(want.ravel(), got.ravel()) / (np.linalg.norm(want) * np.linalg.norm(got))
    assert cos > 0.99999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,long,dp", [
    (1, 32, False, 32), (197, 64, False, 64), (256, 64, False, 64), (256, 32, False, 32),
    (257, 64, True, 64), (257, 32, True, 32), (577, 64, True, 64), (4097, 64, True, 64),
    (197, 80, True, 128), (197, 16, True, 32), (197, 1, True, 32), (197, 96, True, 128),
    (197, 128, True, 128), (197, 129, True, 256), (1025, 256, True, 256),
])
def test_plan_takes_the_short_entry_where_it_can_else_the_long_one(dtype, n, d, long, dp):
    entry, got_dp = attention._plan(n, d, dtype)
    assert entry == (attention._LONG if long else attention._SHORT)[dtype]
    assert got_dp == dp


def test_plan_refuses_what_no_entry_takes():
    with pytest.raises(ValueError, match="MAX_HEAD_DIM = 256"):
        attention._plan(197, 257, torch.bfloat16)
    with pytest.raises(ValueError, match="N >= 1"):
        attention._plan(0, 64, torch.float32)
    with pytest.raises(ValueError, match="f32 or bf16"):
        attention._plan(197, 64, torch.float16)


def test_staged_keeps_stageable_layouts_and_copies_the_rest(rng):
    b, n, h, d = 2, 257, 3, 64
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    q, k, v = (qkv[..., i * h * d : (i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
    # packed-qkv column slices: staged as they lie
    assert all(a is t for a, t in zip(attention._staged(q, k, v, d), (q, k, v)))
    # mixed strides: contiguous copies, equal values
    staged = attention._staged(q, k.contiguous(), v, d)
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in staged)
    assert all(torch.equal(a, t) for a, t in zip(staged, (q, k, v)))
    # token rows not 16-byte aligned (a 4-byte storage offset): copies
    buf = torch.from_numpy(rng.normal(size=(3 * b * n * h * d + 1,)).astype(np.float32))
    q2, k2, v2 = (buf[1:][i * b * n * h * d : (i + 1) * b * n * h * d].view(b, n, h, d) for i in range(3))
    assert q2.data_ptr() % 16 and q2.stride() == k2.stride() == v2.stride()
    staged = attention._staged(q2, k2, v2, d)
    assert all(t.data_ptr() % 16 == 0 and t.is_contiguous() for t in staged)
    assert all(torch.equal(a, t) for a, t in zip(staged, (q2, k2, v2)))
    # (H, D) not dense: copies
    wide = torch.from_numpy(rng.normal(size=(b, n, h, 2 * d)).astype(np.float32))[..., :d]
    assert all(t.is_contiguous() for t in attention._staged(wide, wide, wide, d))
    # a head dim between compiled instances: zero-padded, contiguous
    q80 = torch.from_numpy(rng.normal(size=(b, n, h, 80)).astype(np.float32))
    padded = attention._staged(q80, q80, q80, 128)
    for t in padded:
        assert t.shape == (b, n, h, 128) and t.is_contiguous()
        assert torch.equal(t[..., :80], q80) and not t[..., 80:].any()


def test_padding_the_head_dim_leaves_attention_exact(rng):
    """The long entries run D = 80 at 128: zero dims add nothing to a score
    and their outputs are sliced away (checked with the plain version)."""
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 300, 2, 80)).astype(np.float32)) for _ in range(3))
    want = attention.mha_plain(q, k, v, 80**-0.5)
    got = attention.mha_plain(*attention._staged(q, k, v, 128), 80**-0.5)[..., :80]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _online_tile_width() -> int:
    """Keys a tile of the one-pass f32 kernel (``F1_KT`` in csrc/attention.cu)."""
    src = (Path(attention.__file__).parent.parent / "csrc" / "attention.cu").read_text()
    return int(re.search(r"constexpr int F1_KT = (\d+);", src).group(1))


def _online_emulation(q, k, v, scale, kt):
    """The one-pass f32 kernel's order of operations in plain torch f32, on
    (B, N, H, D) tensors: key tiles of ``kt`` keys, the last cut to the
    narrowest of kt/2, kt/4, ... (down to 8) that holds the rest and its
    keys past N masked to -inf; per tile the running max (scaled by c =
    scale log2(e), -inf before the first tile) raised to the tile's, the
    sums and accumulators rescaled by 2^(m_old - m_new), P = 2^(c s - m)
    unnormalised into P V; one divide by the row sum at the end."""
    b, n, h, d = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    c = scale * math.log2(math.e)
    m = torch.full((b, h, n, 1), -math.inf)
    lsum = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, d))
    for key0 in range(0, n, kt):
        width = kt
        while width > 8 and n - key0 <= width // 2:
            width //= 2
        real = min(width, n - key0)
        s = qf @ kf[:, :, key0:key0 + real].transpose(-1, -2)
        s = torch.cat([s, torch.full((b, h, n, width - real), -math.inf)], dim=-1)
        vt = torch.cat([vf[:, :, key0:key0 + real], torch.zeros((b, h, width - real, d))], dim=-2)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vt
        m = mn
    return (acc / lsum).permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,n,h,d,boost", [(2, 577, 2, 64, 1.0), (2, 641, 2, 32, 1.0), (1, 257, 2, 64, 1.0),
                                           # scores x 8 (q scaled, so the same program): rescaling under stress
                                           (2, 577, 2, 64, 8.0)])
def test_one_pass_online_rescaling_matches_pallas_and_plain_f32(rng, b, n, h, d, boost):
    """The long f32 kernel at D 32 and 64 runs one pass with online
    rescaling instead of an exact softmax; in f32 no cast of P exists, so
    only the rounding order moves: its emulation stays within the file's f32
    bound of the Pallas kernel and within 1e-5 of max |plain| of mha_plain."""
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    q = (q * boost).astype(np.float32)
    want, _ = _run(q, k, v, jnp.float32, torch.float32, d**-0.5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _online_emulation(tq, tk, tv, d**-0.5, _online_tile_width()).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    plain = attention.mha_plain(tq, tk, tv, d**-0.5).numpy()
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


@pytest.mark.parametrize("n", [264, 265, 272, 273, 288, 289])
def test_one_pass_ragged_last_tile_matches_plain_f32(rng, n):
    """N at the edges of the last tile's widths (8, 16, 32 and 64 keys past
    a multiple of 64): the emulation within 1e-5 of max |plain|."""
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 2, 32)).astype(np.float32)) for _ in range(3))
    got = _online_emulation(q, k, v, 32**-0.5, _online_tile_width())
    plain = attention.mha_plain(q, k, v, 32**-0.5)
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()

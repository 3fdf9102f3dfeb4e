"""Plain PyTorch ResNet-50 (He et al. 2016, torchvision layout), DINO
ViT-B/16 (Caron et al. 2021) and the ReLaX-VQA MLP head, written as
functions of a state dict with torchvision / DINO / reference names.

``spec_*`` list every tensor of a state dict (name, shape, kind) so that the
benchmark can draw seeded weights that both the program and this reference
load.  The forwards run in float32.  ``quant`` is applied to both operands
of every convolution and matrix product: the identity for the reference,
an 8-bit float rounding for the precision control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RESNET_STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
# the reference's 15 taps: conv1 (before its BN) and the bottlenecks' outputs, of layer3 only the first four
RESNET_TAPS = ("conv1", "layer1.0", "layer1.1", "layer1.2", "layer2.0", "layer2.1", "layer2.2", "layer2.3",
               "layer3.0", "layer3.1", "layer3.2", "layer3.3", "layer4.0", "layer4.1", "layer4.2")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VIT_DIM, VIT_HEADS, VIT_PATCH, VIT_MLP = 768, 12, 16, 3072


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


# ------------------------------------------------------------------ specs
def _bn(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "one"), (f"{name}.bias", (c,), "zero"),
            (f"{name}.running_mean", (c,), "bn_mean"), (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def spec_resnet50() -> list:
    out = [("conv1.weight", (64, 3, 7, 7), "conv")] + _bn("bn1", 64)
    cin = 64
    for s, (blocks, width, _) in enumerate(RESNET_STAGES, 1):
        for b in range(blocks):
            p = f"layer{s}.{b}"
            out += [(f"{p}.conv1.weight", (width, cin, 1, 1), "conv")] + _bn(f"{p}.bn1", width)
            out += [(f"{p}.conv2.weight", (width, width, 3, 3), "conv")] + _bn(f"{p}.bn2", width)
            out += [(f"{p}.conv3.weight", (4 * width, width, 1, 1), "conv")] + _bn(f"{p}.bn3", 4 * width)
            if b == 0:
                out += [(f"{p}.downsample.0.weight", (4 * width, cin, 1, 1), "conv")] + _bn(f"{p}.downsample.1", 4 * width)
            cin = 4 * width
    return out


def spec_vit(depth: int) -> list:
    d = VIT_DIM
    out = [("cls_token", (1, 1, d), "token"), ("pos_embed", (1, (224 // VIT_PATCH) ** 2 + 1, d), "token"),
           ("patch_embed.proj.weight", (d, 3, VIT_PATCH, VIT_PATCH), "linear"), ("patch_embed.proj.bias", (d,), "zero")]
    for i in range(depth):
        p = f"blocks.{i}"
        out += [(f"{p}.norm1.weight", (d,), "one"), (f"{p}.norm1.bias", (d,), "zero"),
                (f"{p}.attn.qkv.weight", (3 * d, d), "linear"), (f"{p}.attn.qkv.bias", (3 * d,), "zero"),
                (f"{p}.attn.proj.weight", (d, d), "linear"), (f"{p}.attn.proj.bias", (d,), "zero"),
                (f"{p}.norm2.weight", (d,), "one"), (f"{p}.norm2.bias", (d,), "zero"),
                (f"{p}.mlp.fc1.weight", (VIT_MLP, d), "linear"), (f"{p}.mlp.fc1.bias", (VIT_MLP,), "zero"),
                (f"{p}.mlp.fc2.weight", (d, VIT_MLP), "linear"), (f"{p}.mlp.fc2.bias", (d,), "zero")]
    return out + [("norm.weight", (d,), "one"), ("norm.bias", (d,), "zero")]


def spec_head(in_features: int, hidden: int = 256) -> list:
    return ([("fc1.weight", (hidden, in_features), "linear"), ("fc1.bias", (hidden,), "zero")] + _bn("bn1", hidden)
            + [("fc2.weight", (hidden // 2, hidden), "linear"), ("fc2.bias", (hidden // 2,), "zero"),
               ("fc3.weight", (1, hidden // 2), "linear"), ("fc3.bias", (1,), "zero")])


# ---------------------------------------------------------------- forwards
def _conv(x, w, quant, stride=1, padding=0, bias=None):
    return F.conv2d(quant(x), quant(w), bias, stride, padding)


def _bn_eval(x, sd, name):
    return F.batch_norm(x, sd[f"{name}.running_mean"], sd[f"{name}.running_var"], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], False, 0.0, 1e-5)


def resnet50_taps(x: torch.Tensor, sd: dict, quant=_identity) -> dict:
    """(B, 3, 224, 224) normalised RGB -> {tap: (B, C) channel mean} for the
    15 taps (conv1 before its BN, then every bottleneck's output) and
    'avgpool' (B, 2048)."""
    taps = {}
    y = _conv(x, sd["conv1.weight"], quant, 2, 3)
    taps["conv1"] = y.mean(dim=(2, 3))
    y = F.max_pool2d(F.relu(_bn_eval(y, sd, "bn1")), 3, 2, 1)
    for s, (blocks, _, stride) in enumerate(RESNET_STAGES, 1):
        for b in range(blocks):
            p = f"layer{s}.{b}"
            st = stride if b == 0 else 1
            idt = y
            if b == 0:
                idt = _bn_eval(_conv(y, sd[f"{p}.downsample.0.weight"], quant, st), sd, f"{p}.downsample.1")
            z = F.relu(_bn_eval(_conv(y, sd[f"{p}.conv1.weight"], quant), sd, f"{p}.bn1"))
            z = F.relu(_bn_eval(_conv(z, sd[f"{p}.conv2.weight"], quant, st, 1), sd, f"{p}.bn2"))
            y = F.relu(_bn_eval(_conv(z, sd[f"{p}.conv3.weight"], quant), sd, f"{p}.bn3") + idt)
            taps[p] = y.mean(dim=(2, 3))
    taps["avgpool"] = y.mean(dim=(2, 3))
    return taps


def layer_stack(taps: dict) -> torch.Tensor:
    """(B, 13120): the 15 tap means in order."""
    return torch.cat([taps[n] for n in RESNET_TAPS], dim=-1)


def pool_stats(avgpool: torch.Tensor) -> torch.Tensor:
    """(B, 2051): avgpool | its mean | max | std (ddof 0)."""
    return torch.cat([avgpool, avgpool.mean(-1, keepdim=True), avgpool.amax(-1, keepdim=True),
                      avgpool.std(-1, keepdim=True, correction=0)], dim=-1)


def vit_stats(x: torch.Tensor, sd: dict, depth: int, quant=_identity) -> torch.Tensor:
    """(B, 3, 224, 224) RGB in [0, 1] -> (B, 2304) mean | max | std (ddof 0)
    of the 196 patch tokens after the final norm.  Pre-norm blocks, LayerNorm
    eps 1e-6, exact GELU, softmax attention in float32."""
    def lin(t, name):
        return F.linear(quant(t), quant(sd[f"{name}.weight"]), sd[f"{name}.bias"])

    b = x.shape[0]
    y = _conv(x, sd["patch_embed.proj.weight"], quant, VIT_PATCH, 0, sd["patch_embed.proj.bias"]).flatten(2).transpose(1, 2)
    y = torch.cat([sd["cls_token"].expand(b, -1, -1), y], dim=1) + sd["pos_embed"]
    n, hd = y.shape[1], VIT_DIM // VIT_HEADS
    for i in range(depth):
        p = f"blocks.{i}"
        qkv = lin(F.layer_norm(y, (VIT_DIM,), sd[f"{p}.norm1.weight"], sd[f"{p}.norm1.bias"], 1e-6), f"{p}.attn.qkv")
        q, k, v = (qkv[..., j * VIT_DIM:(j + 1) * VIT_DIM].reshape(b, n, VIT_HEADS, hd) for j in range(3))
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", quant(q), quant(k)) * hd**-0.5, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", quant(att), quant(v)).reshape(b, n, VIT_DIM)
        y = y + lin(o, f"{p}.attn.proj")
        h = lin(F.layer_norm(y, (VIT_DIM,), sd[f"{p}.norm2.weight"], sd[f"{p}.norm2.bias"], 1e-6), f"{p}.mlp.fc1")
        y = y + lin(F.gelu(h), f"{p}.mlp.fc2")
    t = F.layer_norm(y, (VIT_DIM,), sd["norm.weight"], sd["norm.bias"], 1e-6)[:, 1:]
    return torch.cat([t.mean(dim=1), t.amax(dim=1), t.std(dim=1, correction=0)], dim=-1)


def head_score(x, sd: dict, quant=_identity) -> float:
    """The MLP head in eval mode on one scaled row, in float64: fc1 ->
    BatchNorm (running stats, eps 1e-5) -> exact GELU -> fc2 -> GELU -> fc3;
    ``quant`` on both operands of each product."""
    def g(name):
        return sd[name].detach().to("cpu", torch.float64)

    def lin(t, name):
        return quant(g(f"{name}.weight")) @ quant(t) + g(f"{name}.bias")

    h = lin(torch.as_tensor(x, dtype=torch.float64), "fc1")
    h = (h - g("bn1.running_mean")) / torch.sqrt(g("bn1.running_var") + 1e-5) * g("bn1.weight") + g("bn1.bias")
    h = F.gelu(lin(F.gelu(h), "fc2"))
    return float(lin(h, "fc3")[0])

"""Paper-plane models (Table II of the paper): CNN-1 / CNN-2 (end devices),
ResNet-10 (edge), ResNet-18 (cloud), as functions over parameter trees.

Counterpart of ``repro.models.cnn``. The public ``apply_*`` functions take
NHWC images, as the reference's do, and compute in NCHW inside. Parameters
keep the reference's tree layout with torch's storage orders: conv weights
are OIHW, and the fc rows after a flatten follow the NCHW (C, H, W) order
(``repro_torch.convert`` maps both from the JAX layout).

BatchNorm is replaced with GroupNorm, as in the reference (running
statistics are ill-defined under federated averaging and online
distillation).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F


def conv_init(gen: torch.Generator, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=gen, dtype=torch.float32)
    return w * (2.0 / fan_in) ** 0.5


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding: the total goes low/high with the odd one high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    """NCHW ``x`` by OIHW ``w`` with XLA's SAME padding.

    A stride-2 3x3 conv on an even input pads (0, 1), not (1, 1); torch's
    symmetric ``padding=1`` gives the same shape but shifted windows, so
    asymmetric cases pad explicitly.
    """
    (ht, hb) = _same_pad(x.shape[2], w.shape[2], stride)
    (wl, wr) = _same_pad(x.shape[3], w.shape[3], stride)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def group_norm(x, scale, bias, groups=4, eps=1e-5):
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x, g, scale, bias, eps)


def linear_init(gen: torch.Generator, din, dout):
    return {
        "w": torch.randn((din, dout), generator=gen, dtype=torch.float32)
        * (din**-0.5),
        "b": torch.zeros((dout,), dtype=torch.float32),
    }


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# CNN-1 / CNN-2 (three-layer CNNs, differ in intermediate widths)
# ---------------------------------------------------------------------------


def init_cnn(gen, num_classes=10, widths=(8, 16, 32), in_ch=3, image=16):
    c1, c2, c3 = widths
    feat = (image // 8) ** 2 * c3  # three stride-2 pools
    return {
        "c1": conv_init(gen, 3, 3, in_ch, c1),
        "c2": conv_init(gen, 3, 3, c1, c2),
        "c3": conv_init(gen, 3, 3, c2, c3),
        "fc": linear_init(gen, feat, num_classes),
    }


def apply_cnn(params, x):
    """x: (N, H, W, C) -> logits (N, num_classes)."""
    x = to_nchw(x)
    for name in ("c1", "c2", "c3"):
        x = F.max_pool2d(F.relu(conv(x, params[name], stride=1)), 2, 2)
    x = x.reshape(x.shape[0], -1)
    return x @ params["fc"]["w"] + params["fc"]["b"]


init_cnn1 = partial(init_cnn, widths=(8, 16, 32))
init_cnn2 = partial(init_cnn, widths=(6, 12, 24))


# ---------------------------------------------------------------------------
# ResNet (basic blocks, GN)
# ---------------------------------------------------------------------------


def _init_block(gen, cin, cout, stride):
    p = {
        "conv1": conv_init(gen, 3, 3, cin, cout),
        "gn1_s": torch.ones((cout,)),
        "gn1_b": torch.zeros((cout,)),
        "conv2": conv_init(gen, 3, 3, cout, cout),
        "gn2_s": torch.ones((cout,)),
        "gn2_b": torch.zeros((cout,)),
    }
    if stride != 1 or cin != cout:
        p["proj"] = conv_init(gen, 1, 1, cin, cout)
    return p


def _apply_block(p, x, stride):
    h = conv(x, p["conv1"], stride)
    h = F.relu(group_norm(h, p["gn1_s"], p["gn1_b"]))
    h = conv(h, p["conv2"], 1)
    h = group_norm(h, p["gn2_s"], p["gn2_b"])
    sc = conv(x, p["proj"], stride) if "proj" in p else x
    return F.relu(h + sc)


def _stage_strides(blocks_per_stage):
    strides = []
    for stage, n in enumerate(blocks_per_stage):
        for b in range(n):
            strides.append(2 if (b == 0 and stage > 0) else 1)
    return strides


def init_resnet(gen, num_classes=10, blocks_per_stage=(1, 1, 1, 1), width=16,
                in_ch=3):
    params = {"stem": conv_init(gen, 3, 3, in_ch, width), "blocks": []}
    cin = width
    for stage, n in enumerate(blocks_per_stage):
        cout = width * (2**stage)
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            params["blocks"].append(_init_block(gen, cin, cout, stride))
            cin = cout
    params["fc"] = linear_init(gen, cin, num_classes)
    return params


def apply_resnet(params, x, blocks_per_stage=(1, 1, 1, 1)):
    """x: (N, H, W, C) -> logits (N, num_classes)."""
    x = F.relu(conv(to_nchw(x), params["stem"], 1))
    for p, s in zip(params["blocks"], _stage_strides(blocks_per_stage)):
        x = _apply_block(p, x, s)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"]


init_resnet10 = partial(init_resnet, blocks_per_stage=(1, 1, 1, 1), width=16)
init_resnet18 = partial(init_resnet, blocks_per_stage=(2, 2, 2, 2), width=16)
apply_resnet10 = partial(apply_resnet, blocks_per_stage=(1, 1, 1, 1))
apply_resnet18 = partial(apply_resnet, blocks_per_stage=(2, 2, 2, 2))

"""The lightweight bridge-sample autoencoder (paper Table II), counterpart of
``repro.models.autoencoder``.

* ``encode(x)``  -> embedding (B, embed_dim)  — lives only on leaf devices.
* ``decode(e)``  -> bridge sample (B, H, W, C) — lives on every node.

Images are NHWC at both ends, as in the reference. Inside, the encoder's fc
rows and the decoder's fc columns follow the NCHW (C, H, W) order, which is
how the port flattens and reshapes; ``repro_torch.convert`` reorders the
reference's (H, W, C) weights to it.

Pre-training happens once on the held-out "open" split. It draws its init
and its batches from seeded ``torch.Generator``\\ s, so it does not
reproduce the reference's ``jax.random`` draws: parity tests compare
converted weights, not the two pretrains.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.cnn import conv, conv_init, linear_init, to_nchw


def init_autoencoder(gen: torch.Generator, image=16, in_ch=3, embed_dim=32,
                     width=16):
    s = image // 4
    return {
        "enc": {
            "c1": conv_init(gen, 3, 3, in_ch, width),
            "c2": conv_init(gen, 3, 3, width, width),
            "fc": linear_init(gen, s * s * width, embed_dim),
        },
        "dec": {
            "fc": linear_init(gen, embed_dim, s * s * width),
            "c1": conv_init(gen, 3, 3, width, width),
            "c2": conv_init(gen, 3, 3, width, in_ch),
        },
    }


def encode(params, x):
    """x: (B, H, W, C) in [0,1] -> (B, embed_dim)."""
    e = params["enc"]
    h = F.relu(conv(to_nchw(x), e["c1"], stride=2))
    h = F.relu(conv(h, e["c2"], stride=2))
    h = h.reshape(h.shape[0], -1)
    return torch.tanh(h @ e["fc"]["w"] + e["fc"]["b"])


def _upsample2(x):
    """Nearest-neighbour 2x upsample of NCHW ``x``."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def decode(params, e, image: int, width: int | None = None, in_ch: int = 3):
    """e: (B, embed_dim) -> bridge samples (B, image, image, in_ch) in [0,1].
    ``width`` is inferred from the decoder fc shape when not given."""
    d = params["dec"]
    s = image // 4
    if width is None:
        width = d["fc"]["w"].shape[1] // (s * s)
    h = F.relu(e @ d["fc"]["w"] + d["fc"]["b"]).reshape(-1, width, s, s)
    h = F.relu(conv(_upsample2(h), d["c1"]))
    h = conv(_upsample2(h), d["c2"])
    return torch.sigmoid(h).permute(0, 2, 3, 1)


def pretrain_autoencoder(seed: int, images, *, image: int, embed_dim: int = 32,
                         steps: int = 1200, lr: float = 2e-3, batch: int = 64,
                         device: torch.device | str = "cuda"):
    """MSE reconstruction pre-training on the open split (AdamW without
    decay). ``images`` is an (N, H, W, C) array; returns params on
    ``device``. The init is drawn from a CPU generator seeded with ``seed``;
    the batch indices from a generator on ``device`` seeded with 1, so the
    loop never waits on the host."""
    from repro_torch.optim import adamw_init, adamw_update_
    from repro_torch.tree import tree_map, value_and_grad

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    params = tree_map(lambda p: p.to(dev),
                      init_autoencoder(gen, image=image, embed_dim=embed_dim))
    x = torch.as_tensor(images, dtype=torch.float32).to(dev)

    def loss_fn(p, xb):
        rec = decode(p, encode(p, xb), image)
        return torch.mean((rec - xb) ** 2)

    opt = adamw_init(params)
    n = x.shape[0]
    batch_gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(steps):
        idx = torch.randint(0, n, (min(batch, n),), generator=batch_gen,
                            device=dev)
        _, g = value_and_grad(loss_fn, params, x[idx])
        params, opt = adamw_update_(g, opt, params, lr=lr, weight_decay=0.0)
    return params

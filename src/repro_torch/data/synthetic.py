"""Class-conditional synthetic image datasets standing in for SVHN /
CIFAR-10 / CINIC-10 (the container is offline; DESIGN.md §assumptions).

Each class c has a smooth "prototype" image (low-frequency random field,
bilinearly upsampled) plus class-specific color statistics; samples are
prototype + per-sample affine jitter + pixel noise. The class structure is
learnable by a small CNN but non-trivial (prototypes overlap through noise),
so accuracy separates weak from strong models and bad from good knowledge
transfer — which is what the paper's tables measure.

Datasets differ in noise level / jitter to mirror relative difficulty:
  synth_svhn     easy     (low noise)       — paper SVHN ~80% band
  synth_cifar10  medium   (more noise)      — paper CIFAR-10 ~34% band
  synth_cinic10  hard     (heavy noise+shift)— paper CINIC-10 ~18% band

An extra held-out "open" split (distribution-shifted: different prototype
seed) is produced for autoencoder pre-training, mirroring the paper's
ImageNet-pretrained autoencoder that never sees device data.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DATASET_PARAMS = {
    "synth_svhn": dict(noise=0.25, jitter=1, proto_scale=1.0),
    "synth_cifar10": dict(noise=0.55, jitter=2, proto_scale=0.8),
    "synth_cinic10": dict(noise=0.85, jitter=3, proto_scale=0.65),
}


@dataclass
class Dataset:
    name: str
    x_train: np.ndarray  # (N, H, W, 3) float32 in [0,1]
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    x_open: np.ndarray  # autoencoder pre-training split (no labels used)
    num_classes: int


def _prototypes(rng, num_classes, image, scale):
    """Low-frequency class prototypes: random 4x4 fields upsampled."""
    base = rng.normal(0, scale, (num_classes, 4, 4, 3))
    # bilinear upsample to (image, image)
    protos = np.zeros((num_classes, image, image, 3), np.float32)
    xs = np.linspace(0, 3, image)
    x0 = np.clip(xs.astype(int), 0, 2)
    fx = xs - x0
    for c in range(num_classes):
        row = (
            base[c, x0] * (1 - fx)[:, None, None]
            + base[c, np.minimum(x0 + 1, 3)] * fx[:, None, None]
        )  # (image, 4, 3)
        img = (
            row[:, x0] * (1 - fx)[None, :, None]
            + row[:, np.minimum(x0 + 1, 3)] * fx[None, :, None]
        )
        protos[c] = img
    return protos


def _sample(rng, protos, labels, noise, jitter):
    n = labels.shape[0]
    image = protos.shape[1]
    x = protos[labels].copy()
    if jitter:
        shifts = rng.integers(-jitter, jitter + 1, (n, 2))
        for i in range(n):
            x[i] = np.roll(x[i], tuple(shifts[i]), axis=(0, 1))
    x = x + rng.normal(0, noise, x.shape)
    x = 1 / (1 + np.exp(-x))  # squash into [0,1]
    return x.astype(np.float32)


def make_dataset(
    name: str,
    *,
    num_train: int = 2048,
    num_test: int = 512,
    num_open: int = 512,
    image: int = 16,
    num_classes: int = 10,
    seed: int = 0,
) -> Dataset:
    if name not in DATASET_PARAMS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_PARAMS)}")
    p = DATASET_PARAMS[name]
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, num_classes, image, p["proto_scale"])

    y_tr = rng.integers(0, num_classes, num_train).astype(np.int32)
    y_te = rng.integers(0, num_classes, num_test).astype(np.int32)
    x_tr = _sample(rng, protos, y_tr, p["noise"], p["jitter"])
    x_te = _sample(rng, protos, y_te, p["noise"], p["jitter"])

    # open split: different prototypes (distribution shift, like ImageNet
    # vs the device data) — used only to pre-train the autoencoder.
    rng_open = np.random.default_rng(seed + 10_000)
    protos_open = _prototypes(rng_open, num_classes, image, p["proto_scale"])
    y_open = rng_open.integers(0, num_classes, num_open).astype(np.int32)
    x_open = _sample(rng_open, protos_open, y_open, p["noise"], p["jitter"])

    return Dataset(name, x_tr, y_tr, x_te, y_te, x_open, num_classes)

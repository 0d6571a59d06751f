"""Parameter conversion between the JAX package's trees and the port's.

Both packages use the same nested dict / list layout and key names. Two
storage orders differ, and the converter permutes them (so a round trip is
bit-exact):

* conv weights: JAX HWIO <-> torch OIHW;
* fc weights fed by a flatten (CNN fc, encoder fc) and the decoder fc that
  feeds a reshape: JAX orders those features (H, W, C), the port, which
  computes in NCHW, orders them (C, H, W).

The JAX side is a tree of numpy arrays (``jax.tree.map(np.asarray, p)``);
the port side is a tree of torch tensors. Model names are those of
``repro_torch.models.registry`` plus ``"autoencoder"``. The LM plane's trees
need no permutation: ``lm_from_jax`` / ``lm_to_jax`` copy them leaf for leaf,
and ``lm_adamw_from_jax`` / ``lm_adamw_to_jax`` their AdamW states.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CNNS = ("cnn1", "cnn2")
RESNETS = ("resnet10", "resnet18")


def _reorder(a: np.ndarray, axis: int, C: int, to_chw: bool) -> np.ndarray:
    """Permute the (H*W*C)-long ``axis`` of ``a`` between (H, W, C) and
    (C, H, W) order (square H = W)."""
    hw = a.shape[axis] // C
    s = math.isqrt(hw)
    if s * s * C != a.shape[axis]:
        raise ValueError(f"axis of {a.shape[axis]} is not s*s*{C}")
    a = np.moveaxis(a, axis, 0)
    rest = a.shape[1:]
    if to_chw:
        a = a.reshape((s, s, C) + rest).transpose((2, 0, 1) + tuple(range(3, 3 + len(rest))))
    else:
        a = a.reshape((C, s, s) + rest).transpose((1, 2, 0) + tuple(range(3, 3 + len(rest))))
    return np.moveaxis(a.reshape((-1,) + rest), 0, axis)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _flatten_channels(name: str, jax_tree) -> dict[tuple, tuple[int, int]]:
    """path -> (axis, C) of every leaf whose features follow a flatten or
    feed a reshape, read off the JAX (HWIO) tree."""
    if name in CNNS:
        return {("fc", "w"): (0, jax_tree["c3"].shape[-1])}
    if name == "autoencoder":
        enc_c = jax_tree["enc"]["c2"].shape[-1]
        dec_c = jax_tree["dec"]["c1"].shape[2]
        return {("enc", "fc", "w"): (0, enc_c),
                ("dec", "fc", "w"): (1, dec_c),
                ("dec", "fc", "b"): (0, dec_c)}
    if name in RESNETS:
        return {}
    raise KeyError(f"unknown model {name!r}")


def from_jax(name: str, jax_tree, device: torch.device | str = "cpu"):
    """JAX numpy tree of model ``name`` -> the port's tensor tree."""
    flat = _flatten_channels(name, jax_tree)

    def fn(path, a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if path in flat:
            axis, C = flat[path]
            a = _reorder(a, axis, C, to_chw=True)
        return torch.from_numpy(np.array(a)).to(device)

    return _map(jax_tree, fn)


def to_jax(name: str, tree):
    """The port's tensor tree of model ``name`` -> JAX-layout numpy tree."""
    np_tree = _map(tree, lambda _, t: t.detach().cpu().numpy())

    def fn(path, a):
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        return a

    hwio = _map(np_tree, fn)
    flat = _flatten_channels(name, hwio)

    def unflat(path, a):
        if path in flat:
            axis, C = flat[path]
            a = _reorder(a, axis, C, to_chw=False)
        return np.ascontiguousarray(a)

    return _map(hwio, unflat)


def adamw_from_jax(name: str, state, device: torch.device | str = "cpu"):
    """AdamW state ``{"step", "m", "v"}``: moments map like the params."""
    return {
        "step": torch.from_numpy(np.array(state["step"])).to(device),
        "m": from_jax(name, state["m"], device),
        "v": from_jax(name, state["v"], device),
    }


def adamw_to_jax(name: str, state):
    return {
        "step": state["step"].detach().cpu().numpy(),
        "m": to_jax(name, state["m"]),
        "v": to_jax(name, state["v"]),
    }


# --- the LM plane -------------------------------------------------------------
#
# The transformer trees have one layout on both sides (weights ``(in, out)``
# applied as ``x @ w``, stacked unit leaves), so the leaves copy one to one
# and never go through ``from_jax``'s HWIO transpose, which would scramble a
# stacked 4-D leaf. bf16 leaves (``ml_dtypes.bfloat16`` in numpy, which
# ``torch.from_numpy`` rejects) travel bit for bit as int16. numpy knows
# bfloat16 by name only where ml_dtypes is loaded, as it is beside JAX;
# elsewhere a bf16 leaf goes to the host as a bf16 torch tensor, which
# ``repro_torch.checkpoint`` writes in the same "bfloat16" format.


def _leaf_from_jax(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy_bfloat16():
    try:
        return np.dtype("bfloat16")
    except TypeError:  # no ml_dtypes in this process
        return None


def _leaf_to_jax(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bf16 = _numpy_bfloat16()
        if bf16 is None:
            return t
        return t.contiguous().view(torch.int16).numpy().view(bf16)
    return t.numpy()


def lm_from_jax(jax_tree, device: torch.device | str = "cpu"):
    """JAX numpy tree of an LM (``repro.models.init_params``, or a decode
    cache) -> the port's tensor tree, bit-exact."""
    return _map(jax_tree, lambda _, a: _leaf_from_jax(a, device))


def lm_to_jax(tree):
    """The port's LM tensor tree -> numpy tree in the JAX layout, bit-exact."""
    return _map(tree, lambda _, t: _leaf_to_jax(t))


def lm_adamw_from_jax(state, device: torch.device | str = "cpu"):
    """An LM's AdamW state ``{"step", "m", "v"}`` (``repro.optim.adamw_init``
    over ``repro.models.init_params``) -> the port's, bit-exact: the moments
    have the params' layout."""
    return {"step": _leaf_from_jax(state["step"], device),
            "m": lm_from_jax(state["m"], device),
            "v": lm_from_jax(state["v"], device)}


def lm_adamw_to_jax(state):
    """The port's LM AdamW state -> numpy tree in the JAX layout, bit-exact."""
    return {"step": _leaf_to_jax(state["step"]),
            "m": lm_to_jax(state["m"]),
            "v": lm_to_jax(state["v"])}

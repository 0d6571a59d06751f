"""The port's AdamW (in place) against the JAX package's (pure)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_init, adamw_update as jax_update
from repro_torch.optim import adamw_init, adamw_update_
from repro_torch.tree import tree_leaves


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "conv": rng.standard_normal((2, 3, 3, 3)).astype(np.float32),
        "b": rng.standard_normal((3,)).astype(np.float32),
        "blocks": [{"s": rng.standard_normal((5,)).astype(np.float32)}],
    }


# within 1e-6: the same fp32 expression, with b**t and the square root
# from two math libraries
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(steps, weight_decay):
    p = _tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.tensor, p)  # a copy: the port updates it in place
    jo, to = jax_init(jp), adamw_init(tp)
    for s in range(steps):
        g = _tree(s + 1)
        jp, jo = jax_update(jax.tree.map(jnp.asarray, g), jo, jp, lr=1e-2,
                            weight_decay=weight_decay)
        tp, to = adamw_update_(jax.tree.map(torch.from_numpy, g), to, tp,
                               lr=1e-2, weight_decay=weight_decay)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jo[k]), tree_leaves(to[k])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    assert int(to["step"]) == int(jo["step"]) == steps
    assert to["step"].dtype == torch.int32


def test_no_decay_below_two_dims():
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    new, _ = adamw_update_(g, adamw_init(p), p, lr=0.5, weight_decay=0.1)
    assert torch.all(new["w"] < 1.0)
    assert torch.equal(new["b"], torch.ones(2))

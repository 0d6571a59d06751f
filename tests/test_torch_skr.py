"""The port's SKR (queue pass + rectification kernel) against the JAX
package's ``lax.scan`` version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skr as J
from repro_torch.core import skr as T


def _state_pair(C, Bq, seed):
    """A non-trivial starting state (partly filled queues, wrapped heads)
    for both packages."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.2, 0.95, (C, Bq)).astype(np.float32)
    count = rng.integers(0, Bq + 1, C).astype(np.int32)
    head = (count % Bq).astype(np.int32)
    jst = {"q": jnp.asarray(q), "count": jnp.asarray(count), "head": jnp.asarray(head)}
    tst = {"q": torch.from_numpy(q), "count": torch.from_numpy(count),
           "head": torch.from_numpy(head)}
    return jst, tst


def _batch(N, C, seed):
    """Probabilities where about half the rows are correctly attributed and
    labels repeat, so later rows of a class see earlier rows' pushes."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, N).astype(np.int32)  # few classes: repeats
    logits = rng.standard_normal((N, C)) * 2.0
    boost = rng.random(N) < 0.5
    logits[boost, labels[boost]] += 6.0
    p = np.exp(logits / 0.5)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32), labels


# count and head exact; q and Q within 1e-6 (the queue mean is an fp32 sum
# of up to Bq values taken in another order)
@pytest.mark.parametrize("N,C,Bq,seed", [(8, 10, 20, 0), (16, 10, 4, 1), (12, 5, 3, 2)])
def test_skr_process_batch_matches_scan(N, C, Bq, seed):
    jst, tst = _state_pair(C, Bq, seed)
    probs, labels = _batch(N, C, seed)
    jnew, jq = J.skr_process_batch(jst, jnp.asarray(probs), jnp.asarray(labels))
    tnew, tq = T.skr_process_batch(tst, torch.from_numpy(probs), torch.from_numpy(labels))
    assert np.array_equal(tnew["count"].numpy(), np.asarray(jnew["count"]))
    assert np.array_equal(tnew["head"].numpy(), np.asarray(jnew["head"]))
    np.testing.assert_allclose(tnew["q"].numpy(), np.asarray(jnew["q"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)


def test_skr_from_empty_state_and_pass_through():
    jst = J.skr_init(10, 20)
    tst = T.skr_init(10, 20)
    probs, labels = _batch(8, 10, 3)
    jnew, jq = J.skr_process_batch(jst, jnp.asarray(probs), jnp.asarray(labels))
    tnew, tq = T.skr_process_batch(tst, torch.from_numpy(probs), torch.from_numpy(labels))
    assert np.array_equal(tnew["count"].numpy(), np.asarray(jnew["count"]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)


def test_queue_means_and_rectify_given_qbar():
    jst, tst = _state_pair(10, 6, 4)
    np.testing.assert_allclose(T.queue_means(tst).numpy(),
                               np.asarray(J.queue_means(jst)), rtol=0, atol=1e-6)
    probs, labels = _batch(8, 10, 4)
    qbar = np.array(J.queue_means(jst))
    count = np.array(jst["count"])
    want = np.asarray(J.rectify_given_qbar(jnp.asarray(probs), jnp.asarray(labels),
                                           jnp.asarray(qbar), jnp.asarray(count)))
    got = T.rectify_given_qbar(torch.from_numpy(probs), torch.from_numpy(labels),
                               torch.from_numpy(qbar), torch.from_numpy(count)).numpy()
    assert np.array_equal(got, want)

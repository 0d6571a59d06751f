"""The port's LM distillation example (``repro_torch.examples.train_lm_distill``)
against the JAX package's script (``examples/train_lm_distill.py``), and the
port's ``serve_decode`` example.

The reference script is run once (``runpy``, its 20 printed steps
included) and its jitted ``teach`` and ``student_step`` are taken from its
globals, with its initial params rebuilt as it builds them (``PRNGKey(0)``
and ``fold_in(key, 1)``) and converted with ``lm_from_jax``. Both sides then
take the script's 20 steps on the same tokens: the teacher's log-knowledge
within 1e-5 every step, SKR's count and head exact and q within 1e-6, the
loss within 1e-5 relative at step 1 and 1e-4 after (the students' params
drift apart by fp32 rounding), and each of the student's gradient leaves at
step 1 within 1e-4 of its max|g|. Pallas runs in interpret mode on the JAX
side (``fused_distill_loss``)."""
import contextlib
import io
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.core.skr import skr_init
from repro_torch.examples import serve_decode
from repro_torch.examples import train_lm_distill as D
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

SCRIPT = Path(__file__).resolve().parents[1] / "examples" / "train_lm_distill.py"
STEPS = 20


@pytest.fixture(scope="module")
def ref():
    """The reference script's globals, and its initial teacher and student
    params as numpy trees."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        g = runpy.run_path(str(SCRIPT))
    assert "done" in out.getvalue()
    key = g["key"]
    pt = g["init_params"](key, g["teacher_cfg"], g["opts_t"])
    ps = g["init_params"](jax.random.fold_in(key, 1), g["student_cfg"], g["opts_s"])
    return g, jax.tree.map(np.asarray, pt), jax.tree.map(np.asarray, ps), out.getvalue()


def _cfgs():
    return reduced(get_arch("llama3.2-3b")), reduced(get_arch("llama3-8b"))


def _jax_grads(g, jps, tokens, labels, tlogq):
    """The gradient of the reference's student loss (its ``loss_fn``, which
    ``student_step`` closes over)."""
    V = g["V"]

    def loss_fn(p):
        z = g["logits_fn"](g["student_cfg"], g["opts_s"], p, tokens)[..., :V]
        return g["fused_distill_loss"](z.reshape(-1, V).astype(jnp.float32), tlogq,
                                       labels.reshape(-1), beta=g["BETA"]).mean()

    return jax.grad(loss_fn)(jps)


@pytest.fixture(scope="module")
def side_by_side(ref):
    """Both sides' 20 steps on the reference's draws: per step (tlogq, SKR
    state, loss) of each, and step 1's gradients."""
    g, pt_np, ps_np, _ = ref
    tcfg, scfg = _cfgs()
    V = min(tcfg.vocab_size, scfg.vocab_size)
    assert V == g["V"] and (D.B, D.S, D.TEMP, D.BETA) == (g["B"], g["S"], g["TEMP"], g["BETA"])
    ot, os_ = D.pair_opts(tcfg), D.pair_opts(scfg)
    pt, ps = lm_from_jax(pt_np), lm_from_jax(ps_np)
    opt, skr = adamw_init(ps), skr_init(V, D.QUEUE_LEN)
    jpt, jps = jax.tree.map(jnp.asarray, pt_np), jax.tree.map(jnp.asarray, ps_np)
    jopt, jskr = g["adamw_init"](jps), g["skr_init"](V, queue_len=20)
    rng = np.random.default_rng(0)
    steps, grads = [], None
    for step in range(STEPS):
        toks = rng.integers(1, V, (g["B"], g["S"] + 1)).astype(np.int32)
        jt, jl = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
        t, lab = torch.from_numpy(toks[:, :-1]).long(), torch.from_numpy(toks[:, 1:]).long()
        jtlogq, jskr = g["teach"](jpt, jskr, jt, jl)
        tlogq, skr = D.teach(tcfg, ot, pt, skr, t, lab, V)
        if step == 0:
            _, got = D.student_grads(scfg, os_, ps, t, lab, tlogq, V)
            want = lm_from_jax(jax.tree.map(np.asarray, _jax_grads(g, jps, jt, jl, jtlogq)))
            grads = (tree_leaves(want), tree_leaves(got))
        jps, jopt, jloss = g["student_step"](jps, jopt, jt, jl, jtlogq)
        ps, opt, loss = D.student_step(scfg, os_, ps, opt, t, lab, tlogq, V)
        steps.append(((np.asarray(jtlogq), {k: np.asarray(v) for k, v in jskr.items()},
                       float(jloss)),
                      (tlogq.numpy(), {k: v.numpy() for k, v in skr.items()}, float(loss))))
    return steps, grads, (pt, lm_from_jax(ps_np))


def test_teacher_knowledge_matches_the_reference_every_step(side_by_side):
    steps, _, _ = side_by_side
    for (want, _, _), (got, _, _) in steps:
        assert got.dtype == np.float32 and got.shape == want.shape == (D.B * D.S, 512)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_skr_state_matches_the_reference_every_step(side_by_side):
    steps, _, _ = side_by_side
    for (_, want, _), (_, got, _) in steps:
        np.testing.assert_array_equal(got["count"], want["count"])
        np.testing.assert_array_equal(got["head"], want["head"])
        np.testing.assert_allclose(got["q"], want["q"], rtol=0, atol=1e-6)
    # the random draws push a few entries (the reference's own run ends with 3)
    assert steps[-1][1][1]["count"].sum() > 0


def test_loss_matches_the_reference_every_step(side_by_side):
    steps, _, _ = side_by_side
    for i, ((_, _, want), (_, _, got)) in enumerate(steps):
        np.testing.assert_allclose(got, want, rtol=1e-5 if i == 0 else 1e-4)


def test_student_gradients_at_step_one_match_the_reference(side_by_side):
    _, (want, got), _ = side_by_side
    assert len(want) == len(got)
    for w, g_ in zip(want, got):
        assert g_.shape == w.shape
        bound = 1e-4 * w.abs().max().clamp_min(1e-30)
        assert (g_ - w).abs().max() <= bound


def test_run_takes_the_reference_script_s_steps(ref, side_by_side):
    """``run`` from the reference's initial params (the draws made by
    ``token_draws``) lands where the script itself did: its last loss, its
    SKR state, and the losses of the side-by-side steps."""
    g, _, _, printed = ref
    steps, _, (pt, ps) = side_by_side
    tcfg, scfg = _cfgs()
    res = D.run(tcfg, scfg, steps=STEPS, pt=pt, ps=ps, device="cpu")
    assert len(res.losses) == len(res.step_s) == len(res.pushes) == STEPS
    np.testing.assert_allclose(res.losses, [s[1][2] for s in steps], rtol=1e-6)
    np.testing.assert_allclose(res.losses[-1], float(g["loss"]), rtol=1e-4)
    for k in ("count", "head"):
        np.testing.assert_array_equal(res.skr[k].numpy(), np.asarray(g["skr"][k]))
    np.testing.assert_allclose(res.skr["q"].numpy(), np.asarray(g["skr"]["q"]), atol=1e-6)
    assert sum(res.pushes) == int(res.skr["count"].sum())
    assert res.params is ps
    for line in printed.splitlines()[1:5]:  # "  step   5 distill loss 6.4036"
        step, loss = int(line.split()[1]), float(line.split()[-1])
        assert abs(res.losses[step - 1] - loss) < 1e-3


def _eq31_labels(g, pt_np, tokens):
    """Labels for the reference teacher's logits on ``tokens``: its argmax on
    the first half of the rows (each pushes p_c into its class's queue),
    and on each later row one of four of those classes that is not the
    row's argmax (misattributed, with a non-empty queue: Eq. 31)."""
    V = g["V"]
    z = g["logits_fn"](g["teacher_cfg"], g["opts_t"], jax.tree.map(jnp.asarray, pt_np),
                       jnp.asarray(tokens))[..., :V]
    top = np.asarray(jnp.argmax(z.reshape(-1, V), -1))
    half = len(top) // 2
    labels = top.copy()
    classes = list(dict.fromkeys(top[:half].tolist()))[:4]
    for i in range(half, len(top)):
        c = classes[i % len(classes)]
        labels[i] = c if c != top[i] else classes[(i + 1) % len(classes)]
    return labels.reshape(tokens.shape).astype(np.int32)


def test_teach_matches_the_reference_where_eq31_fires(ref):
    g, pt_np, _, _ = ref
    tcfg, _ = _cfgs()
    V = g["V"]
    tokens, _ = next(D.token_draws(V, 1))
    labels = _eq31_labels(g, pt_np, tokens)
    jt, jl = jnp.asarray(tokens), jnp.asarray(labels)
    t, lab = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()
    want, wskr = g["teach"](jax.tree.map(jnp.asarray, pt_np), g["skr_init"](V, queue_len=20),
                            jt, jl)
    ot, pt = D.pair_opts(tcfg), lm_from_jax(pt_np)
    got, skr = D.teach(tcfg, ot, pt, skr_init(V, D.QUEUE_LEN), t, lab, V)
    probs, q, _ = D.teacher_knowledge(tcfg, ot, pt, skr_init(V, D.QUEUE_LEN), t, lab, V)
    rows = D.B * D.S
    assert int(skr["count"].sum()) == rows // 2  # every earlier row pushed
    assert int((q != probs).any(1).sum()) == rows - rows // 2  # every later row rectified
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for k in ("count", "head"):
        np.testing.assert_array_equal(skr[k].numpy(), np.asarray(wskr[k]))
    np.testing.assert_allclose(skr["q"].numpy(), np.asarray(wskr["q"]), rtol=0, atol=1e-6)


def test_token_draws_are_the_reference_s():
    rng = np.random.default_rng(0)
    for tokens, labels in D.token_draws(512, 3):
        toks = rng.integers(1, 512, (D.B, D.S + 1)).astype(np.int32)
        np.testing.assert_array_equal(tokens, toks[:, :-1])
        np.testing.assert_array_equal(labels, toks[:, 1:])


def test_main_prints_the_reference_s_lines(capsys):
    res = D.main(["--steps", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "teacher=llama3.2-3b -> student=llama3-8b, V=512"
    assert lines[1] == f"  step   5 distill loss {res.losses[4]:.4f}"
    assert lines[-1].startswith("done")
    assert all(np.isfinite(res.losses))


def test_serve_decode_on_the_cpu(capsys):
    res = serve_decode.main(["--device", "cpu"])
    assert res.tokens.shape == (serve_decode.REQUESTS, serve_decode.GEN_LEN) == (4, 8)
    assert ((res.tokens >= 0) & (res.tokens < reduced(get_arch("rwkv6-1.6b")).vocab_size)).all()
    assert res.logits_finite
    assert "[serve] rwkv6-1.6b on cpu: 4 requests" in capsys.readouterr().out

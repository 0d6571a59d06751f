"""The reference's layouts over a mesh on the port: the sequence-parallel
residual stream (``act_spec``) and the expert-sharded MoE dispatch buffers
(``moe_constrain``), on 8 gloo ranks of a (2, 4) ("data", "model") mesh
(in subprocesses, as ``tests/test_torch_hierarchy.py`` runs its ranks).
Reduced configs of a dense GQA (llama3.2-3b), an MoE (qwen2-moe-a2.7b), an
MLA (deepseek-v2-lite-16b) and an RWKV6 (rwkv6-1.6b) family, the params
from the reference's ``init_params`` converted with ``lm_from_jax``, laid
out by ``param_specs`` and the batch by ``batch_specs``
(``distribute_tree``): the prefill step's logits and one training
forward's loss and gradient leaves, gathered (``gather_tree``), held
against the JAX package's single-device forward and gradient (logits 1e-4
of max|logit|, loss 1e-5 relative, each gradient leaf 1e-4 of its max|g|)
and against the port's one-device run of the same step (1e-5 of each
max|x|, loss 1e-5 relative); one ``make_train_step`` on the mesh (ZeRO-1
moments by ``zero1_specs``) against the one-device step: its loss, grad
norm and moments 1e-5 (of each leaf's max), and every updated param leaf
the AdamW update of the mesh's own moments to 1e-6, a few fp32 ulps of
the params (the params themselves are not held to the one-device step's:
AdamW's first step scales each element to about the learning rate
whatever its gradient, so an element near ``eps`` moves by a good part of
it from an fp32 rounding).
One decode step of one sequence, its cache sequence-sharded by
``cache_specs``, against the one-device step (logits and the written
cache 1e-5). Every kernel op of the laid-out steps returns a DTensor. On
one device
the layout options leave a plain forward as it was."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.models import ModelOpts as JaxOpts
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.steps import (
    default_opts,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.transformer import forward_train, init_cache
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, value_and_grad

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "rwkv6-1.6b"]
B, S = 4, 16
MESH = MeshSpec(("data", "model"), (2, 4))
LR = 1e-2

RANK = r"""
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (default_opts, make_prefill_step, make_serve_step,
                                     make_train_step)
from repro_torch.models.transformer import forward_train, init_cache
from repro_torch.optim import adamw_init
from repro_torch.sharding import batch_specs, cache_specs, param_specs, zero1_specs
from repro_torch.sharding.specs import distribute_tree, gather_tree
from repro_torch.tree import tree_leaves, tree_unflatten

rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 8), rank=rank, world_size=8)
mesh = make_host_mesh(2, 4, device="cpu")
with open(inp, "rb") as f:
    job = pickle.load(f)
plain = []  # kernel ops that returned a plain tensor for DTensor inputs


def watch(name):
    fn = getattr(ops, name)

    def wrapped(*a, **kw):
        got = fn(*a, **kw)
        if any(isinstance(t, DTensor) for t in a):
            outs = got if isinstance(got, tuple) else (got,)
            plain.extend(name for t in outs if not isinstance(t, DTensor))
        return got
    setattr(ops, name, wrapped)


for name in ("flash_attention", "latent_decode", "rwkv6_scan", "fused_softmax_xent"):
    watch(name)
res = {}
for arch, (changes, jp, batch) in job["archs"].items():
    cfg = dataclasses.replace(reduced(get_arch(arch)), **changes)
    opts = default_opts(cfg, mesh, seq_parallel=True, moe_constrain=True)
    params = lm_from_jax(jp)
    pspec = param_specs(cfg, opts, params, mesh)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    db = distribute_tree(bt, batch_specs(cfg, "train", bt["tokens"].shape[0], mesh), mesh)
    dp = distribute_tree(params, pspec, mesh)
    logits = make_prefill_step(cfg, opts)(dp, {"tokens": db["tokens"]})
    assert isinstance(logits, DTensor), type(logits)
    with implicit_replication():
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(dp)]
        loss, aux = forward_train(cfg, opts, tree_unflatten(dp, leaves), db)
        grads = torch.autograd.grad(loss, leaves)
    r = {"logits": logits.full_tensor().detach().numpy(),
         "loss": loss.full_tensor().detach().numpy(),
         "grads": [g.full_tensor().numpy() for g in grads]}
    del leaves, grads
    state = distribute_tree(adamw_init(params),
                            {"step": (), "m": zero1_specs(pspec, params, mesh),
                             "v": zero1_specs(pspec, params, mesh)}, mesh)
    dp, state, m = make_train_step(cfg, opts, lr=job["lr"])(dp, state, db)
    r["step_loss"] = m["loss"].full_tensor().numpy()
    r["grad_norm"] = m["grad_norm"].full_tensor().numpy()
    r["updated"] = [t.numpy() for t in tree_leaves(gather_tree(dp))]
    r["m"] = [t.numpy() for t in tree_leaves(gather_tree(state["m"]))]
    r["v"] = [t.numpy() for t in tree_leaves(gather_tree(state["v"]))]
    # one decode step of one sequence: its cache laid out by cache_specs,
    # whose sequence goes over the data axes (a batch of 1 does not divide them)
    S = bt["tokens"].shape[1]
    cache = init_cache(cfg, opts, 1, S, torch.float32, device="cpu")
    dc = distribute_tree(cache, cache_specs(cfg, opts, cache, mesh, batch=1, seq=S), mesh)
    dtok = distribute_tree({"token": bt["tokens"][:1, :1], "pos": S - 2},
                           batch_specs(cfg, "decode", 1, mesh), mesh)
    # fresh params: the step above updated dp, whose shards may alias params
    _, lg, dc = make_serve_step(cfg, opts)(distribute_tree(lm_from_jax(jp), pspec, mesh), dc,
                                           dtok)
    r["decode_logits"] = lg.full_tensor().numpy()
    r["decode_cache"] = [t.numpy() for t in tree_leaves(gather_tree(dc))]
    res[arch] = r
res["plain"] = plain
if rank == 0:
    with open(out, "wb") as f:
        pickle.dump(res, f)
dist.destroy_process_group()
"""


def _configs(arch):
    # qwen2-moe-a2.7b at capacity factor 0.5, so the busiest experts drop
    # tokens (as tests/test_torch_train_families.py runs it)
    changes = {"capacity_factor": 0.5} if arch == "qwen2-moe-a2.7b" else {}
    return (dataclasses.replace(jax_reduced(jax_get_arch(arch)), **changes),
            dataclasses.replace(reduced(get_arch(arch)), **changes), changes)


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), what


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's single-device results, the port's one-device
    results and the 8 gloo ranks' gathered results, per architecture (the
    ranks run while the references are computed)."""
    tmp = tmp_path_factory.mktemp("layouts")
    rng = np.random.default_rng(0)
    job, setups = {"lr": LR, "archs": {}}, {}
    for arch in ARCHS:
        jcfg, cfg, changes = _configs(arch)
        opts = default_opts(cfg, MESH, seq_parallel=True, moe_constrain=True)
        # the reference's params shaped as the mesh shapes them (KV heads
        # replicated kv_mult times, experts padded), with no layout
        jo = JaxOpts(kv_mult=opts.kv_mult, expert_pad_to=opts.expert_pad_to,
                     attn_chunk=opts.attn_chunk, remat=True)
        jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), jcfg, jo))
        batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        job["archs"][arch] = (changes, jp, batch)
        setups[arch] = (jcfg, cfg, opts, jo, jp, batch)
    inp, out = tmp / "job.pkl", tmp / "out.pkl"
    with open(inp, "wb") as f:
        pickle.dump(job, f)
    ranks = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(tmp / "store"), str(inp),
                               str(out)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(8)]
    want, one = {}, {}
    for arch, (jcfg, cfg, opts, jo, jp, batch) in setups.items():
        jparams = jax.tree.map(jnp.asarray, jp)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        wl, wg = jax.value_and_grad(lambda p: jax_forward_train(jcfg, jo, p, jb)[0])(jparams)
        want[arch] = {
            "logits": np.asarray(jax_forward_prefill(jcfg, jo, jparams, {"tokens": jb["tokens"]})),
            "loss": np.asarray(wl),
            "grads": [t.numpy() for t in tree_leaves(lm_from_jax(jax.tree.map(np.asarray, wg)))]}
        # the port on one device: the same opts but the layouts
        o1 = dataclasses.replace(opts, act_spec=None, moe_constrain=False)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        params = lm_from_jax(jp)
        logits = make_prefill_step(cfg, o1)(params, {"tokens": tb["tokens"]})
        loss, g = value_and_grad(lambda p: forward_train(cfg, o1, p, tb)[0], params)
        _, st, m = make_train_step(cfg, o1, lr=LR)(lm_from_jax(jp), adamw_init(params), tb)
        one[arch] = {"logits": logits.numpy(), "loss": loss.numpy(),
                     "grads": [t.numpy() for t in tree_leaves(g)],
                     "step_loss": m["loss"].numpy(), "grad_norm": m["grad_norm"].numpy(),
                     "params": [t.numpy() for t in tree_leaves(params)],
                     "m": [t.numpy() for t in tree_leaves(st["m"])],
                     "v": [t.numpy() for t in tree_leaves(st["v"])]}
        cache = init_cache(cfg, o1, 1, S, torch.float32, device="cpu")
        _, lg, cache = make_serve_step(cfg, o1)(
            params, cache, {"token": tb["tokens"][:1, :1], "pos": S - 2})
        one[arch].update(decode_logits=lg.numpy(),
                         decode_cache=[t.numpy() for t in tree_leaves(cache)])
    logs = [p.communicate(timeout=300)[0] for p in ranks]
    assert all(p.returncode == 0 for p in ranks), "\n".join(logs)
    with open(out, "rb") as f:
        got = pickle.load(f)
    return want, one, got


def test_no_kernel_op_returns_a_plain_tensor_for_dtensor_inputs(runs):
    _, _, got = runs
    assert got["plain"] == []


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_on_the_mesh(runs, arch):
    want, one, got = runs
    g = got[arch]["logits"]
    _close(g, want[arch]["logits"], 1e-4, "vs JAX")
    _close(g, one[arch]["logits"], 1e-5, "vs one device")


@pytest.mark.parametrize("arch", ARCHS)
def test_training_loss_and_gradients_on_the_mesh(runs, arch):
    want, one, got = runs
    g = got[arch]
    np.testing.assert_allclose(g["loss"], want[arch]["loss"], rtol=1e-5)
    np.testing.assert_allclose(g["loss"], one[arch]["loss"], rtol=1e-5)
    assert len(g["grads"]) == len(want[arch]["grads"]) == len(one[arch]["grads"])
    for i, (a, w, o) in enumerate(zip(g["grads"], want[arch]["grads"], one[arch]["grads"])):
        _close(a, w, 1e-4, f"grad leaf {i} vs JAX")
        _close(a, o, 1e-5, f"grad leaf {i} vs one device")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_mesh(runs, arch):
    _, one, got = runs
    g, o = got[arch], one[arch]
    np.testing.assert_allclose(g["step_loss"], o["step_loss"], rtol=1e-5)
    np.testing.assert_allclose(g["grad_norm"], o["grad_norm"], rtol=1e-5)
    for k in ("m", "v"):
        for i, (a, b) in enumerate(zip(g[k], o[k])):
            _close(a, b, 1e-5, f"{k} leaf {i}")
    # the step's own arithmetic (optim.adamw_update_, step 1) on the mesh's moments
    bc1, bc2 = np.float32(1 - 0.9), np.float32(1 - 0.95)
    for i, (new, p, m, v) in enumerate(zip(g["updated"], o["params"], g["m"], g["v"])):
        wd = np.float32(0.1 if p.ndim >= 2 else 0.0)
        want = p - (m / bc1 / (np.sqrt(v / bc2) + np.float32(1e-8)) + wd * p) * np.float32(LR)
        assert new.shape == p.shape and np.abs(new - want).max() <= 1e-6, f"updated leaf {i}"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_a_sequence_sharded_cache(runs, arch):
    """A decode step's logits and the cache it writes, gathered, equal the
    one-device step's: each device writes the slot its shard holds."""
    _, one, got = runs
    _close(got[arch]["decode_logits"], one[arch]["decode_logits"], 1e-5, "logits")
    assert len(got[arch]["decode_cache"]) == len(one[arch]["decode_cache"])
    for i, (a, b) in enumerate(zip(got[arch]["decode_cache"], one[arch]["decode_cache"])):
        _close(a, b, 1e-5, f"cache leaf {i}")


def test_layouts_leave_a_plain_forward_as_it_was():
    """On plain tensors ``act_spec`` and ``moe_constrain`` do nothing: the
    forward with them is the forward without them, bit for bit."""
    _, cfg, _ = _configs("qwen2-moe-a2.7b")
    base = default_opts(cfg, remat=False)
    params = lm_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(1), jax_reduced(jax_get_arch("qwen2-moe-a2.7b")), JaxOpts())))
    tok = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    want = make_prefill_step(cfg, base)(params, {"tokens": tok})
    for opts in (dataclasses.replace(base, act_spec=("data", "model", None)),
                 dataclasses.replace(base, moe_constrain=True),
                 default_opts(cfg, MeshSpec(("data", "model"), (16, 16)), seq_parallel=True,
                              moe_constrain=True, remat=False, kv_mult=1, expert_pad_to=1)):
        assert torch.equal(make_prefill_step(cfg, opts)(params, {"tokens": tok}), want)

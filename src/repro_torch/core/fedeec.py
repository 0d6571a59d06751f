"""FedEEC: recursive knowledge agglomeration over the EEC-NET (Algorithm 3),
counterpart of ``repro.core.fedeec``.

Two phases per run:
  * Init: every leaf encodes its private data with the frozen encoder and
    sends (ε, y) up the tree; every interior node stores the union of its
    subtree's embeddings.
  * Train rounds: post-order traversal; every (child, parent) pair runs
    BSBODP(+SKR): child-as-student then parent-as-student, distilling over
    bridge samples dec(ε) of the child's subtree embeddings.

FedAgg (the INFOCOM'24 predecessor) is exactly this with SKR disabled
(``use_skr=False``) — the ablation the paper reports in Table III.

Parameters, optimizer and SKR states live on ``device``. The embedding
stores stay host numpy, indexed by draws from ``np.random.default_rng(seed)``
in the reference's order, so a run consumes the generator call for call as
the reference does.

Under the simulator (``repro_torch.sim``) pairs that share a
``batch_signature`` and no node coalesce into one ``execute_batch``: each
step of the group runs the B pairs' models stacked leafwise
(``tree_stack``), the model through ``torch.func.vmap`` of its
``apply_fn`` and the loss and SKR through the kernels' (B, N, V) entries
outside the vmap, so a group's student step is one ``distill_loss``
forward and backward launch (two for data-holding students) and its
teacher step one fused SKR launch, whatever B is. The rng draws go in the
reference's batched order (pair-major within a step).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core import bsbodp
from repro_torch.core.protocols import BSBODP_SKR
from repro_torch.core.skr import skr_init, skr_process_batch
from repro_torch.core.topology import Tree
from repro_torch.device import resolve_device
from repro_torch.fl.api import FLAlgorithm, WorkItem, register_algorithm
from repro_torch.models.autoencoder import decode, encode
from repro_torch.models.registry import get_fl_model
from repro_torch.optim import adamw_init, adamw_update_, adamw_update_stacked_
from repro_torch.tree import tree_map, tree_stack, tree_unstack, value_and_grad


def node_generator(seed: int, i: int) -> torch.Generator:
    """The CPU generator node ``i`` of a run seeded ``seed`` draws its
    initial parameters from."""
    s = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


class FedEEC(FLAlgorithm):
    # BSBODP(+SKR) imposes no structural relation on parent-child model
    # pairs (R = V x V): every migration is legal (Theorem 1)
    protocol = BSBODP_SKR

    def __init__(
        self,
        cfg: FLConfig,
        tree: Tree,
        client_data: dict[str, tuple[np.ndarray, np.ndarray]],
        auto_params,
        *,
        use_skr: bool = True,
        model_of: dict[str, str] | None = None,
        seed: int = 0,
        device="cuda",
        params: dict[str, object] | None = None,
    ):
        """``params`` optionally gives each node's initial parameters (a
        tree per node, e.g. converted from the reference, which the trainer
        copies, as it updates its own in place); otherwise node ``i`` of
        ``tree.nodes`` draws them from ``node_generator(seed, i)``."""
        super().__init__(cfg, tree)
        self.device = resolve_device(device)
        self.auto = tree_map(lambda t: t.to(self.device), auto_params)
        self.use_skr = use_skr
        self.rng = np.random.default_rng(seed)

        # tier -> model assignment
        self.model_of: dict[str, str] = {}
        leaves = tree.leaves
        for v in tree.nodes:
            if model_of and v in model_of:
                self.model_of[v] = model_of[v]
            elif tree.is_leaf(v):
                if cfg.end_model_hetero and leaves.index(v) % 2 == 1:
                    self.model_of[v] = cfg.end_model_hetero
                else:
                    self.model_of[v] = cfg.end_model
            elif v == tree.root:
                self.model_of[v] = cfg.cloud_model
            else:
                self.model_of[v] = cfg.edge_model

        # node states
        self.params: dict[str, object] = {}
        self.opt: dict[str, object] = {}
        self.skr: dict[str, object] = {}
        self.apply: dict[str, object] = {}
        for i, v in enumerate(tree.nodes):
            init_fn, apply_fn = get_fl_model(self.model_of[v])
            if params is not None:
                p = params[v]
            else:
                p = init_fn(node_generator(seed, i), cfg.num_classes,
                            cfg.image_size)
            p = tree_map(lambda t: t.to(self.device, copy=True), p)
            self.params[v] = p
            self.opt[v] = adamw_init(p)
            self.skr[v] = skr_init(cfg.num_classes, cfg.queue_len, self.device)
            self.apply[v] = apply_fn

        self.client_data = client_data
        self.embeddings: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        # per-row provenance of every embedding store: which device each
        # sample came from (index into the sorted device list). Drives
        # cohort-weighted bridge sampling under population-scale
        # scenarios; maintained at the same three sites as the stores
        # themselves (init / gather / migrate)
        self.embed_src: dict[str, np.ndarray] = {}
        self._src_names: list[str] = sorted(client_data)
        self._src_pos: dict[str, int] = {
            v: i for i, v in enumerate(self._src_names)}
        self._bridge_p_cache: dict[str, np.ndarray] = {}
        # (node, peer, reason) of BSBODP pairs lost to faults — the
        # knowledge that never agglomerated
        self.failed_pairs: list[tuple[str, str, str]] = []
        self._init_phase()

    # ------------------------------------------------------------------ init

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    @torch.no_grad()
    def _init_phase(self):
        """Leaves encode private data; embeddings propagate to the root."""
        for v in self.tree.post_order():
            if self.tree.is_leaf(v):
                x, y = self.client_data[v]
                eps = encode(self.auto, self._to_device(x)).cpu().numpy()
                self.embeddings[v] = (eps, y.copy())
                self.embed_src[v] = np.full(
                    len(y), self._src_pos[v], dtype=np.int32)
                # upload (ε, y): (|ε| + 1) per sample — Table VII init term
                link = self.comm.link_kind(self.tree, v)
                self.comm.record(link, eps.size + len(y), "init-embed")
            elif v != self.tree.root:
                self._gather_children(v)
        self._gather_children(self.tree.root)

    def _gather_children(self, v):
        es, ys, ss = [], [], []
        for c in self.tree.children[v]:
            e, y = self.embeddings[c]
            es.append(e)
            ys.append(y)
            ss.append(self.embed_src[c])
            if v != self.tree.root:
                link = self.comm.link_kind(self.tree, v)
                self.comm.record(link, e.size + y.size, "relay-embed")
        self.embeddings[v] = (np.concatenate(es), np.concatenate(ys))
        self.embed_src[v] = np.concatenate(ss)

    # ----------------------------------------------------------------- steps

    @torch.no_grad()
    def _teacher_step(self, model_name, params, skr_state, bridge_x, labels,
                      stacked=False):
        """``stacked``: B teachers of one architecture, params and SKR
        states stacked leafwise and bridge_x (B, bs, ...); the model runs
        under ``torch.func.vmap``."""
        apply_fn = get_fl_model(model_name)[1]
        if stacked:
            apply_fn = torch.func.vmap(apply_fn)
        z = apply_fn(params, bridge_x)
        probs = torch.softmax(z / self.cfg.temperature, dim=-1)
        new_state, q = skr_process_batch(skr_state, probs, labels)
        return probs, q, new_state

    def _student_step(self, model_name, leaf: bool, params, opt, bx, by, tq,
                      lx=None, ly=None):
        apply_fn = get_fl_model(model_name)[1]
        beta, gamma = self.cfg.beta, self.cfg.gamma
        if leaf:
            def loss_fn(p):
                zl = apply_fn(p, lx)
                zb = apply_fn(p, bx)
                return bsbodp.leaf_loss(zl, ly, zb, by, tq, beta, gamma)
        else:
            def loss_fn(p):
                return bsbodp.non_leaf_loss(apply_fn(p, bx), by, tq, beta)
        l, g = value_and_grad(loss_fn, params)
        params, opt = adamw_update_(g, opt, params, lr=self.cfg.lr,
                                    weight_decay=0.0)
        return params, opt, l

    def _student_step_batched(self, model_name, leaf: bool, params, opt, bx, by,
                              tq, lx=None, ly=None):
        """``_student_step`` for B stacked students of one architecture.
        Only the model is vmapped; the losses take its (B, N, V) outputs.
        The gradient is that of the sum over pairs of each pair's loss, so
        pair b's slice is its own loss's gradient. Returns the sum."""
        apply_fn = torch.func.vmap(get_fl_model(model_name)[1])
        beta, gamma = self.cfg.beta, self.cfg.gamma
        if leaf:
            def loss_fn(p):
                zl = apply_fn(p, lx)
                zb = apply_fn(p, bx)
                return bsbodp.leaf_loss_batched(zl, ly, zb, by, tq, beta,
                                                gamma).sum()
        else:
            def loss_fn(p):
                return bsbodp.non_leaf_loss_batched(apply_fn(p, bx), by, tq,
                                                    beta).sum()
        l, g = value_and_grad(loss_fn, params)
        params, opt = adamw_update_stacked_(g, opt, params, lr=self.cfg.lr,
                                            weight_decay=0.0)
        return params, opt, l

    # ------------------------------------------------------------- protocol

    def _bsbodp_directional(self, v_s: str, v_t: str):
        """One direction: v_t teaches v_s over bridge samples of the shared
        (= intersection of leaf sets = student∩teacher subtree) embeddings."""
        cfg = self.cfg
        pair_node = self._pair_child(v_s, v_t)
        eps, labels = self.embeddings[pair_node]
        n = len(labels)
        if n == 0:  # subtree emptied by migration — nothing to distill over
            return
        bs = min(cfg.batch_size, n)
        # "leaf" = data-holding end device; an edge whose clients all
        # migrated away is tree-leaf but must not train on client data
        is_leaf = v_s in self.client_data
        link = self.comm.link_kind(self.tree, pair_node)

        steps = self.pair_steps(v_s, v_t)
        for _ in range(steps):
            idx = self._bridge_choice(pair_node, n, bs)
            y_b = self._to_device(labels[idx]).long()
            with torch.no_grad():
                bridge = decode(self.auto, self._to_device(eps[idx]),
                                cfg.image_size)
            probs, q, self.skr[v_t] = self._teacher_step(
                self.model_of[v_t], self.params[v_t], self.skr[v_t], bridge,
                y_b)
            tq = q if self.use_skr else probs
            # teacher -> student: (|z| + 1) per sample (Table VII round term)
            self.comm.record(link, bs * (cfg.num_classes + 1), "logits")
            if is_leaf:
                lx, ly = self.client_data[v_s]
                li = self.rng.choice(len(ly), size=min(bs, len(ly)),
                                     replace=len(ly) < bs)
                self.params[v_s], self.opt[v_s], _ = self._student_step(
                    self.model_of[v_s], True, self.params[v_s], self.opt[v_s],
                    bridge, y_b, tq, self._to_device(lx[li]),
                    self._to_device(ly[li]).long())
            else:
                self.params[v_s], self.opt[v_s], _ = self._student_step(
                    self.model_of[v_s], False, self.params[v_s],
                    self.opt[v_s], bridge, y_b, tq)

    def _bridge_choice(self, node: str, n: int, bs: int) -> np.ndarray:
        """Bridge-sample index draw over ``node``'s embedding store. With
        default size-1 cohorts this is the uniform draw; under a
        population-scale scenario rows are drawn proportionally to their
        source device's cohort size (``rng.choice`` with ``p=``, which
        consumes the generator differently, as the reference's does)."""
        if not self._cohort_sizes:
            return self.rng.choice(n, size=bs, replace=n < bs)
        return self.rng.choice(n, size=bs, replace=n < bs,
                               p=self._bridge_p(node))

    def _bridge_p(self, node: str) -> np.ndarray:
        p = self._bridge_p_cache.get(node)
        if p is None:
            sizes = np.array([float(self.cohort_size(nm))
                              for nm in self._src_names])
            w = sizes[self.embed_src[node]]
            p = w / w.sum()
            self._bridge_p_cache[node] = p
        return p

    def set_cohort_sizes(self, sizes) -> None:
        super().set_cohort_sizes(sizes)
        self._bridge_p_cache.clear()

    def bsbodp_pair(self, v1: str, v2: str):
        """Algorithm 1/2: both directions."""
        self._bsbodp_directional(v1, v2)
        self._bsbodp_directional(v2, v1)

    def _pair_child(self, v1: str, v2: str) -> str:
        """The child side of pair (v1, v2) — owner of the shared embeddings."""
        return v1 if self.tree.parent.get(v1) == v2 else v2

    def _bsbodp_directional_batched(self, pairs: list[tuple[str, str]]):
        """Batched ``_bsbodp_directional``: B same-signature pairs with
        disjoint node sets run each step once over stacked (params, opt,
        SKR) trees. Per-pair numerics match serial execution given the same
        per-pair rng draws; the draws go pair-major within a step (the
        reference's order), not step-major within a pair. Each node gets
        its own tensors back (``tree_unstack``)."""
        cfg = self.cfg
        B = len(pairs)
        v_s0, v_t0 = pairs[0]
        children = [self._pair_child(vs, vt) for vs, vt in pairs]
        embs = [self.embeddings[c] for c in children]
        bs = min(cfg.batch_size, len(embs[0][1]))
        steps = self.pair_steps(v_s0, v_t0)
        is_leaf = v_s0 in self.client_data
        m_t, m_s = self.model_of[v_t0], self.model_of[v_s0]
        links = [self.comm.link_kind(self.tree, c) for c in children]

        P_t = tree_stack([self.params[vt] for _, vt in pairs])
        S_t = tree_stack([self.skr[vt] for _, vt in pairs])
        P_s = tree_stack([self.params[vs] for vs, _ in pairs])
        O_s = tree_stack([self.opt[vs] for vs, _ in pairs])

        for _ in range(steps):
            idx = [self._bridge_choice(c, len(e[1]), bs)
                   for c, e in zip(children, embs)]
            e_b = np.stack([e[0][i] for e, i in zip(embs, idx)])
            y_b = self._to_device(np.stack([e[1][i] for e, i in zip(embs, idx)])).long()
            with torch.no_grad():
                flat = decode(self.auto, self._to_device(
                    e_b.reshape((-1,) + e_b.shape[2:])), cfg.image_size)
            bridge = flat.reshape((B, bs) + flat.shape[1:])
            probs, q, S_t = self._teacher_step(m_t, P_t, S_t, bridge, y_b,
                                               stacked=True)
            tq = q if self.use_skr else probs
            for link in links:
                self.comm.record(link, bs * (cfg.num_classes + 1), "logits")
            if is_leaf:
                lxs, lys = [], []
                for vs, _ in pairs:
                    lx, ly = self.client_data[vs]
                    li = self.rng.choice(len(ly), size=min(bs, len(ly)),
                                         replace=len(ly) < bs)
                    lxs.append(lx[li])
                    lys.append(ly[li])
                P_s, O_s, _ = self._student_step_batched(
                    m_s, True, P_s, O_s, bridge, y_b, tq,
                    self._to_device(np.stack(lxs)),
                    self._to_device(np.stack(lys)).long())
            else:
                P_s, O_s, _ = self._student_step_batched(
                    m_s, False, P_s, O_s, bridge, y_b, tq)

        for (vs, vt), p, o, st in zip(pairs, tree_unstack(P_s, B),
                                      tree_unstack(O_s, B), tree_unstack(S_t, B)):
            self.params[vs], self.opt[vs], self.skr[vt] = p, o, st

    def pair_steps(self, v1: str, v2: str) -> int:
        """Distill steps one direction of pair (v1, v2) runs — the single
        formula ``_bsbodp_directional`` and its callers use."""
        pair_node = self._pair_child(v1, v2)
        n = len(self.embeddings[pair_node][1])
        if n == 0:
            return 0
        bs = min(self.cfg.batch_size, n)
        return self.cfg.distill_steps or min(
            max(1, (n + bs - 1) // bs), self.cfg.max_distill_steps
        )

    # ------------------------------------------------------------ training

    def round_pairs(self) -> list[tuple[str, str]]:
        """The round's (child, parent) pairs in post-order."""
        return [
            (v, self.tree.parent[v])
            for v in self.tree.post_order()
            if v != self.tree.root
        ]

    def work_items(self, round: int, online) -> list[WorkItem]:
        """One bidirectional BSBODP "pair" item per (child, parent) link,
        in post-order (Algorithm 3's subtree-before-parent order)."""
        return [
            WorkItem("pair", node=v, peer=p, link=self.link_of(v),
                     steps=self.pair_steps(v, p))
            for v, p in self.round_pairs()
        ]

    def execute(self, item: WorkItem) -> None:
        self.bsbodp_pair(item.node, item.peer)

    def batch_signature(self, item: WorkItem):
        """Pairs coalesce when both sides' architectures, leaf-ness, step
        count, and every per-step batch shape agree — exactly the fields
        that make the stacked dispatch shape-compatible and the per-item
        comm bytes identical."""
        if item.kind != "pair" or item.steps <= 0:
            return None
        v, p = item.node, item.peer
        n = len(self.embeddings[self._pair_child(v, p)][1])
        if n == 0:
            return None
        bs = min(self.cfg.batch_size, n)
        sig = ("pair", self.model_of[v], self.model_of[p],
               v in self.client_data, p in self.client_data, item.steps, bs)
        for u in (v, p):
            if u in self.client_data:
                n_local = len(self.client_data[u][1])
                sig += (min(bs, n_local), n_local < bs)
        return sig

    def execute_batch(self, items: list[WorkItem]) -> None:
        """Coalesced BSBODP: each direction of every pair in the group as
        stacked steps (child-as-student for all pairs, then parent-as-
        student; pairs share no node, so interleaving the directions across
        pairs changes no pair's own numerics)."""
        if len(items) == 1:
            self.execute(items[0])
            return
        pairs = [(it.node, it.peer) for it in items]
        self._bsbodp_directional_batched([(v, p) for v, p in pairs])
        self._bsbodp_directional_batched([(p, v) for v, p in pairs])

    def on_item_failed(self, item: WorkItem, reason: str) -> None:
        """A BSBODP pair was lost to faults. The pair never executed:
        neither direction distilled and the teacher's SKR queue never saw
        the bridge batch, so the pair is out of this round's agglomeration
        by construction. Record the loss so callers can see what went
        missing."""
        self.failed_pairs.append((item.node, item.peer, reason))

    # -- checkpoint state ----------------------------------------------------

    def state_arrays(self):
        """Params and AdamW states in the reference's layout
        (``convert.to_jax`` per node's model), SKR states and the
        embedding stores as host numpy."""
        return {
            "params": {v: convert.to_jax(self.model_of[v], p)
                       for v, p in self.params.items()},
            "opt": {v: convert.adamw_to_jax(self.model_of[v], o)
                    for v, o in self.opt.items()},
            "skr": {v: {k: t.cpu().numpy() for k, t in st.items()}
                    for v, st in self.skr.items()},
            "embeddings": self.embeddings,
        }

    def state_meta(self) -> dict:
        meta = super().state_meta()
        meta["rng"] = self.rng.bit_generator.state
        meta["failed_pairs"] = [list(t) for t in self.failed_pairs]
        return meta

    def load_state(self, meta: dict, arrays) -> None:
        """Every node's params and AdamW state, its step counter included
        (the batched path's stacked AdamW reads each node's own), onto the
        trainer's device."""
        super().load_state(meta, arrays)
        self.rng.bit_generator.state = meta["rng"]
        self.failed_pairs = [
            (str(a), str(b), str(c)) for a, b, c in meta["failed_pairs"]
        ]
        dev = self.device
        self.params = {v: convert.from_jax(self.model_of[v], p, dev)
                       for v, p in arrays["params"].items()}
        self.opt = {v: convert.adamw_from_jax(self.model_of[v], o, dev)
                    for v, o in arrays["opt"].items()}
        self.skr = {v: {k: torch.from_numpy(np.array(a)).to(dev) for k, a in st.items()}
                    for v, st in arrays["skr"].items()}
        # embedding stores are host-side numpy (indexed by the rng draws)
        self.embeddings = {
            v: (np.asarray(e), np.asarray(y))
            for v, (e, y) in arrays["embeddings"].items()
        }
        # provenance is derivable from (restored topology, client_data):
        # rebuilt instead of checkpointed
        self._rebuild_embed_src()

    def _rebuild_embed_src(self) -> None:
        """Provenance from (topology, client_data), in the same child order
        the stores concatenate — row i of a store and of its provenance
        always describe the same sample."""
        self.embed_src = {}
        for v in self.tree.post_order():
            if v in self.client_data:
                self.embed_src[v] = np.full(
                    len(self.embeddings[v][1]), self._src_pos[v],
                    dtype=np.int32)
            else:
                parts = [self.embed_src[c] for c in self.tree.children[v]]
                self.embed_src[v] = (np.concatenate(parts) if parts
                                     else np.zeros((0,), dtype=np.int32))
        self._bridge_p_cache.clear()

    def _model_params(self, node: str):
        return self.params[node]

    def _do_migrate(self, node: str, new_parent: str):
        """Dynamic migration (§IV-E): legal for any pair under BSBODP+SKR.

        The moved subtree's embeddings are (a) dropped from the stores on
        the old parent→root path, (b) re-registered up the new path — and
        the re-registration upload is charged on the CommMeter per the
        Table VII init term ((|ε|+1) per sample per hop). Only the two
        affected root paths are recomputed.
        """
        old_parent = self.tree.parent[node]
        self.tree.migrate(node, new_parent)
        affected = {
            v for v in self.tree.path_to_root(old_parent)
            + self.tree.path_to_root(new_parent)
            if v not in self.client_data
        }
        for v in sorted(affected, key=self.tree.tier, reverse=True):
            es, ys, ss = [], [], []
            for c in self.tree.children[v]:
                e, y = self.embeddings[c]
                es.append(e)
                ys.append(y)
                ss.append(self.embed_src[c])
            if es:
                self.embeddings[v] = (np.concatenate(es), np.concatenate(ys))
                self.embed_src[v] = np.concatenate(ss)
            else:
                self.embeddings[v] = (
                    np.zeros((0,) + self.embeddings[node][0].shape[1:],
                             dtype=self.embeddings[node][0].dtype),
                    np.zeros((0,), dtype=self.embeddings[node][1].dtype),
                )
                self.embed_src[v] = np.zeros((0,), dtype=np.int32)
        self._bridge_p_cache.clear()
        # charge the subtree's (ε, y) upload on every hop of the new path
        eps, ys_ = self.embeddings[node]
        hop = node
        while hop != self.tree.root:
            link = self.comm.link_kind(self.tree, hop)
            self.comm.record(link, eps.size + ys_.size, "migrate-embed")
            hop = self.tree.parent[hop]

    def cloud_params(self):
        return self.params[self.tree.root]

    def cloud_apply(self):
        return self.apply[self.tree.root]


@register_algorithm("fedeec")
def _fedeec(cfg, tree, client_data, auto, *, device="cuda"):
    return FedEEC(cfg, tree, client_data, auto, use_skr=True, seed=cfg.seed,
                  device=device)


@register_algorithm("fedagg")
def _fedagg(cfg, tree, client_data, auto, *, device="cuda"):
    # the INFOCOM'24 predecessor == FedEEC with SKR disabled (Table III)
    return FedEEC(cfg, tree, client_data, auto, use_skr=False, seed=cfg.seed,
                  device=device)

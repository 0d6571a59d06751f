"""Baseline HFL algorithms (paper §V-A.3) on the FLAlgorithm work-item API,
counterpart of ``repro.fl.baselines``.

All parameter-aggregation baselines deploy the SAME model structure on every
node (paper §V-B.3: uniformly M_end^1, since aggregation requires it) — that
is precisely the bottleneck effect FedEEC removes.

  * HierFAVG  (Liu et al., ICC'20): κ1 local steps, edge aggregation, κ2
    edge rounds, cloud aggregation, redistribute.
  * HierMo    (Yang et al., TPDS'23): HierFAVG + server-side momentum
    aggregation (aggregation-level momentum, as the reference simplifies it).
  * HierQSGD  (Liu et al., TWC'23): HierFAVG with uniformly-quantized
    deltas on both hops (8-bit stochastic uniform quantization).
  * DemLearn-lite (Nguyen et al., TNNLS'23): self-organizing hierarchy —
    clients re-clustered by label histogram every round; plain averaging.
  * FedAvg    (two-tier flat reference).

A round decomposes into one "local" work item per participating client
plus one "aggregate" item per edge; the cloud aggregation is the
``end_round`` barrier. Offline / non-participating clients' items are
skipped by the scheduler, so dropout removes them from the
``aggregate_params`` weights instead of silently training everyone.

A local step's loss is the mean cross-entropy ``logsumexp(z) − z[y]`` (no
clamp), which is ``core.bsbodp.softmax_xent``: on the card one launch of
distill_loss's CE entry forward and one backward, the plain version on
CPU tensors. AdamW runs in place with no weight decay, each client on its
own copy of the model it starts from and its own optimizer state, which
persists across rounds. The numpy generator is consumed call for call as
the reference's: the local batch draws, HierQSGD's quantization draws (in
the reference's layout, ``_quantize``) and DemLearn's k-means seeds.
Dispatch stays serial (no ``batch_signature``), as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core.bsbodp import softmax_xent
from repro_torch.core.protocols import PARAM_AVG, aggregate_params
from repro_torch.core.topology import Tree
from repro_torch.device import resolve_device
from repro_torch.fl.api import FLAlgorithm, WorkItem, register_algorithm
from repro_torch.models.registry import get_fl_model
from repro_torch.optim import adamw_init, adamw_update_
from repro_torch.tree import tree_leaves, tree_map, value_and_grad


def _num_floats(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


def local_loss(apply_fn, params, x, y):
    """The baselines' local objective: mean CE of the logits, unclamped."""
    return softmax_xent(apply_fn(params, x), y)


def _map_sorted(fn, tree):
    """``fn`` over the leaves of a numpy tree, called in ``jax.tree.map``'s
    leaf order (dict keys sorted), the structure kept."""
    if isinstance(tree, dict):
        out = {k: _map_sorted(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_sorted(fn, v) for v in tree)
    return fn(tree)


def _quantize(delta, levels: int = 256, rng=None):
    """Stochastic uniform quantization (QSGD-style) of a numpy tree in the
    reference's layout: the reference's numpy arithmetic, one
    ``rng.random(x.shape)`` draw per leaf, leaves in ``jax.tree.map``'s
    order, each draw landing on the element of the reference's storage
    order, so the result and the generator state are the reference's."""
    def q(x):
        x = np.asarray(x, np.float32)
        scale = np.max(np.abs(x)) + 1e-12
        y = x / scale * (levels // 2)
        low = np.floor(y)
        p = y - low
        r = rng.random(x.shape) if rng is not None else 0.5
        yq = low + (r < p)
        return (yq / (levels // 2) * scale).astype(np.float32)

    return _map_sorted(q, delta)


class HierarchicalFedAvg(FLAlgorithm):
    """HierFAVG family engine; momentum/quantization/self-organization are
    knobs on the same two-stage aggregation loop."""

    # identical structures on every node: parameter averaging is an
    # equivalence protocol — any re-parenting is legal (Theorem 1)
    protocol = PARAM_AVG

    def __init__(
        self,
        cfg: FLConfig,
        tree: Tree,
        client_data: dict[str, tuple[np.ndarray, np.ndarray]],
        *,
        momentum: float = 0.0,
        quantize: bool = False,
        self_organize: bool = False,
        kappa1: int = 1,
        kappa2: int = 1,
        seed: int = 0,
        device="cuda",
        params=None,
    ):
        """``params`` optionally gives the initial global parameters (e.g.
        converted from the reference), which the trainer copies; otherwise
        they are drawn from ``torch.Generator().manual_seed(seed)``."""
        super().__init__(cfg, tree)
        self.device = resolve_device(device)
        self.client_data = client_data
        self.momentum = momentum
        self.quantize = quantize
        self.self_organize = self_organize
        self.kappa1, self.kappa2 = kappa1, kappa2
        self.rng = np.random.default_rng(seed)

        init_fn, apply_fn = get_fl_model(cfg.end_model)
        self.apply_fn = apply_fn
        if params is None:
            params = init_fn(torch.Generator().manual_seed(seed), cfg.num_classes,
                             cfg.image_size)
        self.global_params = tree_map(lambda t: t.to(self.device, copy=True), params)
        self.opt = {v: adamw_init(self.global_params) for v in tree.leaves}
        self._momentum_buf = None
        self._nfloats = _num_floats(self.global_params)
        # per-round scratch: edge -> [(client, params)], edge -> params
        self._round_updates: dict[str, list] = {}
        self._edge_params: dict[str, object] = {}
        self._edge_weight: dict[str, float] = {}

    def _model_params(self, node: str):
        return self.global_params

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _client_update(self, v: str, params):
        """κ1·local_steps AdamW steps of client ``v`` from a copy of
        ``params`` (the steps update in place), on its own optimizer state."""
        x, y = self.client_data[v]
        p = tree_map(lambda t: t.clone(), params)
        opt = self.opt[v]
        n = len(y)
        bs = min(self.cfg.batch_size, n)
        for _ in range(self.cfg.local_steps * self.kappa1):
            idx = self.rng.choice(n, size=bs, replace=n < bs)
            xb, yb = self._to_device(x[idx]), self._to_device(y[idx]).long()
            _, g = value_and_grad(lambda q: local_loss(self.apply_fn, q, xb, yb), p)
            p, opt = adamw_update_(g, opt, p, lr=self.cfg.lr, weight_decay=0.0)
        self.opt[v] = opt
        return p

    def _trained_params(self, v: str, base):
        """κ1 local steps from ``base``, with optional QSGD quantization of
        the resulting delta (in the reference's layout, so the draws land
        where the reference's do)."""
        p = self._client_update(v, base)
        if self.quantize:
            name = self.cfg.end_model
            delta = convert.to_jax(name, tree_map(lambda a, b: a - b, p, base))
            delta = convert.from_jax(name, _quantize(delta, rng=self.rng), self.device)
            p = tree_map(lambda b, d: b + d, base, delta)
        return p

    def _maybe_cluster(self):
        """DemLearn-lite: re-assign clients to edges by label-histogram
        k-means (self-organizing hierarchy). Moves go through the
        protocol gate; PARAM_AVG is an equivalence so none is refused."""
        if not self.self_organize:
            return
        C = self.cfg.num_classes
        leaves = self.tree.leaves
        hists = np.stack([
            np.bincount(self.client_data[v][1], minlength=C) for v in leaves
        ]).astype(np.float64)
        hists /= hists.sum(1, keepdims=True)
        edges = [v for v in self.tree.nodes
                 if not self.tree.is_leaf(v) and v != self.tree.root]
        k = len(edges)
        centers = hists[self.rng.choice(len(leaves), k, replace=False)]
        for _ in range(5):
            d = ((hists[:, None] - centers[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for j in range(k):
                sel = hists[assign == j]
                if len(sel):
                    centers[j] = sel.mean(0)
        for i, v in enumerate(leaves):
            target = edges[int(assign[i])]
            if self.tree.parent[v] != target:
                self.try_migrate(v, target)

    # -- work-item decomposition -------------------------------------------

    def begin_round(self, round: int) -> None:
        self._maybe_cluster()
        self._round_updates = {}
        self._edge_params = {}
        self._edge_weight = {}

    def work_items(self, round: int, online) -> list[WorkItem]:
        """Per-client "local" items (κ1 steps each) followed by one
        "aggregate" item per edge; an edge's aggregation waits for its
        clients via the scheduler's peer-of dependency rule."""
        items: list[WorkItem] = []
        root = self.tree.root
        for e in self.tree.children[root]:
            for c in self.tree.children[e]:
                if self.tree.is_leaf(c):
                    items.append(WorkItem(
                        "local", node=c, peer=e, link=self.link_of(c),
                        steps=self.cfg.local_steps * self.kappa1,
                    ))
            items.append(WorkItem(
                "aggregate", node=e, peer=root, link=self.link_of(e),
            ))
        return items

    def execute(self, item: WorkItem) -> None:
        if item.kind == "local":
            p = self._trained_params(item.node, self.global_params)
            self._round_updates.setdefault(item.peer, []).append((item.node, p))
            # up + down parameter transfer on the client's access link
            self.comm.record(item.link, 2 * self._nfloats, "params")
            return
        # "aggregate": edge-level FedAvg over this round's participants
        e = item.node
        ups = self._round_updates.get(e, [])
        if not ups:
            # no participating clients: the edge just relays the global model
            self._edge_params[e] = self.global_params
            self._edge_weight[e] = 0.0
            self.comm.record(item.link, 2 * self._nfloats, "params")
            return
        # FedAvg sample counts (Python ints), scaled by cohort multiplicity:
        # weighted cohorts stay bitwise exact FedAvg
        weights = [self.cohort_size(c) * len(self.client_data[c][1])
                   for c, _ in ups]
        ep = aggregate_params([p for _, p in ups], weights)
        # κ2 > 1: the remaining edge rounds iterate locally under this edge,
        # billed to the edge's "aggregate" item as in the reference (exact
        # for the κ2 = 1 every registered variant uses)
        for _ in range(self.kappa2 - 1):
            ups = [(c, self._trained_params(c, ep)) for c, _ in ups]
            for c, _ in ups:
                self.comm.record(self.link_of(c), 2 * self._nfloats, "params")
            ep = aggregate_params([p for _, p in ups], weights)
        self._edge_params[e] = ep
        self._edge_weight[e] = float(sum(weights))
        # edge <-> cloud parameter exchange
        self.comm.record(item.link, 2 * self._nfloats, "params")

    def on_item_failed(self, item: WorkItem, reason: str) -> None:
        """Drop the lost participant from the FedAvg weight vector. A
        failed item never executed, so normally nothing is staged; the
        clean-up covers subclasses that stage state eagerly: a lost "local"
        item removes that client from its edge's weights, a lost
        "aggregate" item zeroes the edge out of the cloud aggregation."""
        if item.kind == "local":
            ups = self._round_updates.get(item.peer)
            if ups:
                self._round_updates[item.peer] = [
                    (c, p) for c, p in ups if c != item.node
                ]
        elif item.kind == "aggregate":
            self._edge_params.pop(item.node, None)
            self._edge_weight[item.node] = 0.0

    # -- checkpoint state ----------------------------------------------------

    def state_arrays(self):
        name = self.cfg.end_model
        arrays = {"global": convert.to_jax(name, self.global_params),
                  "opt": {v: convert.adamw_to_jax(name, o) for v, o in self.opt.items()}}
        if self._momentum_buf is not None:
            arrays["momentum"] = convert.to_jax(name, self._momentum_buf)
        return arrays

    def state_meta(self) -> dict:
        meta = super().state_meta()
        meta["rng"] = self.rng.bit_generator.state
        return meta

    def load_state(self, meta: dict, arrays) -> None:
        super().load_state(meta, arrays)
        self.rng.bit_generator.state = meta["rng"]
        name = self.cfg.end_model
        self.global_params = convert.from_jax(name, arrays["global"], self.device)
        self.opt = {v: convert.adamw_from_jax(name, o, self.device)
                    for v, o in arrays["opt"].items()}
        m = arrays.get("momentum")
        self._momentum_buf = None if m is None else convert.from_jax(name, m, self.device)

    def end_round(self, round: int) -> None:
        """Cloud aggregation barrier: only edges whose subtree actually
        trained this round carry weight, so dropout changes the aggregate."""
        edges = [e for e in self.tree.children[self.tree.root]
                 if self._edge_weight.get(e, 0.0) > 0.0]
        if not edges:
            return  # total outage: the global model is unchanged
        agg = aggregate_params(
            [self._edge_params[e] for e in edges],
            [self._edge_weight[e] for e in edges],
        )
        if self.momentum:
            if self._momentum_buf is None:
                self._momentum_buf = tree_map(torch.zeros_like, agg)
            delta = tree_map(lambda a, b: a - b, agg, self.global_params)
            self._momentum_buf = tree_map(
                lambda m, d: self.momentum * m + d, self._momentum_buf, delta
            )
            agg = tree_map(lambda g, m: g + m, self.global_params, self._momentum_buf)
        self.global_params = agg

    def cloud_params(self):
        return self.global_params

    def cloud_apply(self):
        return self.apply_fn


class FlatFedAvg(HierarchicalFedAvg):
    """Two-tier FedAvg: one 'edge' == the server."""

    def __init__(self, cfg: FLConfig, client_data, *, seed: int = 0, device="cuda",
                 params=None):
        tree = Tree.three_tier(1, cfg.num_clients)
        super().__init__(cfg, tree, client_data, seed=seed, device=device,
                         params=params)


@register_algorithm("hierfavg")
def _hierfavg(cfg, tree, client_data, auto, *, device="cuda"):
    return HierarchicalFedAvg(cfg, tree, client_data, seed=cfg.seed, device=device)


@register_algorithm("hiermo")
def _hiermo(cfg, tree, client_data, auto, *, device="cuda"):
    return HierarchicalFedAvg(cfg, tree, client_data, momentum=0.9,
                              seed=cfg.seed, device=device)


@register_algorithm("hierqsgd")
def _hierqsgd(cfg, tree, client_data, auto, *, device="cuda"):
    return HierarchicalFedAvg(cfg, tree, client_data, quantize=True,
                              seed=cfg.seed, device=device)


@register_algorithm("demlearn")
def _demlearn(cfg, tree, client_data, auto, *, device="cuda"):
    return HierarchicalFedAvg(cfg, tree, client_data, self_organize=True,
                              seed=cfg.seed, device=device)


@register_algorithm("fedavg")
def _fedavg(cfg, tree, client_data, auto, *, device="cuda"):
    return FlatFedAvg(cfg, client_data, seed=cfg.seed, device=device)

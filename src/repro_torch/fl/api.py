"""FL-algorithm work-item API (paper §IV-E framing), counterpart of
``repro.fl.api``.

Every trainer is an :class:`FLAlgorithm`: it decomposes a round into
:class:`WorkItem`\\ s, executes them one at a time, and declares the
interaction :class:`~repro_torch.core.protocols.Protocol` that decides
which migrations are legal (Theorems 1-2).

Round lifecycle:

    begin_round(r)
    for item in work_items(r, online):
        execute(item)
    end_round(r)

Algorithms register themselves under a name in the port's own registry
(the reference's registry refuses duplicate names, so the two cannot
share one)::

    @register_algorithm("myalg")
    def _build(cfg, tree, client_data, auto, *, device):
        return MyAlg(cfg, tree, client_data, device=device)

The simulator (``repro_torch.sim``) drives the same trainers through the
hooks below: participation masks, refusal hooks, fault hooks, weighted
cohorts, dispatch groups (``batch_signature`` / ``execute_batch``:
FedEEC coalesces its same-shape pairs; the base class runs every item
alone) and checkpoint state (``state_arrays`` / ``state_meta`` /
``load_state``, in the reference's layout, so that either package resumes
the other's checkpoints). Under an active tracer (``repro_torch.obs``),
``train_round`` opens one ``execute {kind} {node}`` span per work item.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Iterable, NamedTuple, Optional

from repro_torch.core.protocols import Protocol
from repro_torch.core.topology import Tree, link_kind
from repro_torch.fl.comm import CommMeter
from repro_torch.obs.trace import active_tracer


class WorkItem(NamedTuple):
    """One schedulable unit of a training round.

    kind:
      "pair"       bidirectional BSBODP distillation between node and peer
      "local"      local SGD on ``node``, result destined for ``peer``
      "aggregate"  ``node`` aggregates its children's results for ``peer``
    ``node`` is the child side of the link the item's traffic crosses;
    ``steps`` is the compute step count.
    """

    kind: str
    node: str
    peer: str = ""
    link: str = ""
    steps: int = 1


class MigrationRefused(RuntimeError):
    """A migration the algorithm's interaction protocol forbids (Thm 2)."""

    def __init__(self, node: str, new_parent: str, protocol: Protocol):
        self.node, self.new_parent, self.protocol = node, new_parent, protocol
        super().__init__(
            f"protocol {protocol.name!r} ({protocol.kind}) refuses "
            f"re-parenting {node!r} under {new_parent!r}"
        )


class FLAlgorithm(ABC):
    """Abstract FL trainer: work-item decomposition + protocol-gated
    migration + participation masking, over a shared ``Tree``."""

    #: interaction protocol governing migration legality (§IV-E)
    protocol: Protocol | None = None

    def __init__(self, cfg, tree: Tree):
        self.cfg = cfg
        self.tree = tree
        self.comm = CommMeter()
        self.participation: frozenset[str] | None = None
        self._round = 0
        self._refuse_hooks: list[Callable[[str, str, str], None]] = []
        self._cohort_sizes: dict[str, int] = {}

    # -- round decomposition ----------------------------------------------

    @abstractmethod
    def work_items(self, round: int, online: Callable[[str], bool]) -> list[WorkItem]:
        """The round's full work-item list in deterministic order, at most
        one item per node. Items whose participants are offline are
        *included*; the caller decides what to skip, and ``online`` lets
        adaptive algorithms reshape the round instead."""

    @abstractmethod
    def execute(self, item: WorkItem) -> None:
        """Run one work item, recording its traffic on ``self.comm``."""

    # -- dispatch groups -----------------------------------------------------

    def batch_signature(self, item: WorkItem):
        """Hashable dispatch-compatibility key for ``item``, or ``None``
        when the item must run alone. The simulator may hand a group of
        items whose signatures compare equal, and that share no participant
        node, to :meth:`execute_batch` as one dispatch. The default opts
        every item out of coalescing."""
        return None

    def execute_batch(self, items: list[WorkItem]) -> None:
        """Run a group of same-signature, participant-disjoint items: the
        serial fallback. An override must record the same per-item comm
        bytes as serial execution would."""
        for item in items:
            self.execute(item)

    def begin_round(self, round: int) -> None:
        """Pre-round hook (e.g. DemLearn re-clustering). May migrate."""

    def end_round(self, round: int) -> None:
        """Post-round barrier across items (e.g. cloud aggregation)."""

    def on_item_failed(self, item: WorkItem, reason: str) -> None:
        """A scheduled item was lost to faults (``reason`` in
        {"abandoned", "timeout", "departed"}). The item was never executed,
        so no state or comm traffic exists to roll back; overrides record
        the loss. The default is a no-op."""

    # -- checkpoint state (repro_torch.checkpoint) --------------------------

    def state_arrays(self):
        """Array tree of the trainer's resumable state, written by
        ``repro_torch.checkpoint.save_pytree``: host numpy in the
        reference's layout (``convert.to_jax``). Pair with
        :meth:`state_meta`."""
        return {}

    def state_meta(self) -> dict:
        """JSON-serializable non-array state (round counters, numpy
        generator states, whose >64-bit ints msgpack cannot hold)."""
        return {"round": self._round}

    def load_state(self, meta: dict, arrays) -> None:
        """Restore from :meth:`state_meta` / :meth:`state_arrays` output (the
        port's or the reference's), onto the trainer's device. Overrides
        must restore every field their ``state_*`` methods saved: a resumed
        run's event signature must be bit-identical to an uninterrupted
        one."""
        self._round = int(meta.get("round", 0))

    # -- weighted cohorts ---------------------------------------------------

    def set_cohort_sizes(self, sizes: dict[str, int]) -> None:
        """Declare each materialized device as the representative of a
        homogeneous cohort of ``sizes[v]`` identical devices. The simulator
        calls this once at construction when the scenario declares a
        ``population``; by default every cohort has size 1."""
        self._cohort_sizes = {str(v): int(n) for v, n in sizes.items()}

    def cohort_size(self, v: str) -> int:
        """Cohort multiplicity of device ``v`` (an int, 1 by default)."""
        return self._cohort_sizes.get(v, 1)

    # -- participation ------------------------------------------------------

    def set_participation(self, mask: Optional[Iterable[str]]) -> None:
        """Restrict data-holding devices to ``mask`` (None = everyone).
        Non-device nodes always participate."""
        self.participation = None if mask is None else frozenset(mask)

    def participates(self, v: str) -> bool:
        if self.participation is None or not self.tree.is_device(v):
            return True
        return v in self.participation

    # -- plain (round-counted) execution ------------------------------------

    def train_round(self) -> None:
        """One round over the participating nodes (every node, unless a
        mask was set). Under an active tracer each executed item is an
        ``execute {kind} {node}`` span (cat ``execute``)."""
        r = self._round
        tr = active_tracer()
        self.begin_round(r)
        for item in self.work_items(r, self.participates):
            if self.participates(item.node) and (
                not item.peer or self.participates(item.peer)
            ):
                if tr is None:
                    self.execute(item)
                else:
                    with tr.span(f"execute {item.kind} {item.node}",
                                 cat="execute", round=r, node=item.node,
                                 peer=item.peer):
                        self.execute(item)
        self.end_round(r)
        self._round += 1

    # -- migration (§IV-E) ---------------------------------------------------

    def on_migrate_refused(self, hook: Callable[[str, str, str], None]) -> None:
        """Register a callback fired with (node, target, reason) whenever a
        migration is refused — the simulator logs these."""
        self._refuse_hooks.append(hook)

    def migrate(self, node: str, new_parent: str) -> None:
        """Re-parent ``node`` under ``new_parent`` iff the declared
        protocol's relation allows it; raise :class:`MigrationRefused`
        (after notifying refuse hooks) otherwise."""
        if self.protocol is not None and not self.protocol.allows_migration(
            self._model_params, node, new_parent
        ):
            for hook in self._refuse_hooks:
                hook(node, new_parent, "protocol")
            raise MigrationRefused(node, new_parent, self.protocol)
        self._do_migrate(node, new_parent)

    def try_migrate(self, node: str, new_parent: str) -> bool:
        """Non-raising :meth:`migrate`; refuse hooks still fire."""
        try:
            self.migrate(node, new_parent)
        except MigrationRefused:
            return False
        return True

    def _do_migrate(self, node: str, new_parent: str) -> None:
        """Protocol-approved re-parenting; override to move algorithm state
        along with the node."""
        self.tree.migrate(node, new_parent)

    def _model_params(self, node: str):
        """Model parameters deployed on ``node``."""
        return None

    # -- cloud model ---------------------------------------------------------

    @abstractmethod
    def cloud_params(self):
        """Parameters of the cloud (root) model under evaluation."""

    @abstractmethod
    def cloud_apply(self):
        """apply_fn(params, x) -> logits for the cloud model."""

    # -- helpers -------------------------------------------------------------

    def link_of(self, node: str) -> str:
        return link_kind(self.tree, node)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

AlgorithmFactory = Callable[..., FLAlgorithm]

ALGORITHM_REGISTRY: dict[str, AlgorithmFactory] = {}


def register_algorithm(name: str):
    """Register ``factory(cfg, tree, client_data, auto, *, device) ->
    FLAlgorithm`` under a name."""

    def deco(factory: AlgorithmFactory) -> AlgorithmFactory:
        if name in ALGORITHM_REGISTRY:
            raise ValueError(f"duplicate algorithm {name!r}")
        ALGORITHM_REGISTRY[name] = factory
        return factory

    return deco


def _load_builtin() -> None:
    # registration side effects live next to the class definitions
    import repro_torch.core.fedeec  # noqa: F401
    import repro_torch.fl.baselines  # noqa: F401


def create_algorithm(name: str, cfg, tree, client_data, auto, *,
                     device="cuda") -> FLAlgorithm:
    """Construct a registered algorithm from the config and the shared
    problem inputs (see ``repro_torch.fl.engine.build_problem``)."""
    _load_builtin()
    key = name.lower()
    if key not in ALGORITHM_REGISTRY:
        raise KeyError(
            f"unknown algorithm {name!r}; known: {list_algorithms()}"
        )
    return ALGORITHM_REGISTRY[key](cfg, tree, client_data, auto, device=device)


def list_algorithms() -> list[str]:
    _load_builtin()
    return sorted(ALGORITHM_REGISTRY)

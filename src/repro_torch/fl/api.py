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

The simulator's batched dispatch, participation masks, refusal hooks,
fault hooks, checkpoint state, weighted cohorts and tracer spans come with
the port's simulator slice.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, NamedTuple

from repro_torch.core.protocols import Protocol
from repro_torch.core.topology import Tree, link_kind
from repro_torch.fl.comm import CommMeter


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
    migration, over a shared ``Tree``."""

    #: interaction protocol governing migration legality (§IV-E)
    protocol: Protocol | None = None

    def __init__(self, cfg, tree: Tree):
        self.cfg = cfg
        self.tree = tree
        self.comm = CommMeter()
        self._round = 0

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

    def begin_round(self, round: int) -> None:
        """Pre-round hook (e.g. DemLearn re-clustering). May migrate."""

    def end_round(self, round: int) -> None:
        """Post-round barrier across items (e.g. cloud aggregation)."""

    # -- plain (round-counted) execution ------------------------------------

    def train_round(self) -> None:
        """One round with every node online."""
        r = self._round
        self.begin_round(r)
        for item in self.work_items(r, lambda v: True):
            self.execute(item)
        self.end_round(r)
        self._round += 1

    # -- migration (§IV-E) ---------------------------------------------------

    def migrate(self, node: str, new_parent: str) -> None:
        """Re-parent ``node`` under ``new_parent`` iff the declared
        protocol's relation allows it; raise :class:`MigrationRefused`
        otherwise."""
        if self.protocol is not None and not self.protocol.allows_migration(
            self._model_params, node, new_parent
        ):
            raise MigrationRefused(node, new_parent, self.protocol)
        self._do_migrate(node, new_parent)

    def try_migrate(self, node: str, new_parent: str) -> bool:
        """Non-raising :meth:`migrate`."""
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
    # registration side effects live next to the class definitions; the
    # baselines join with their slice of the port
    import repro_torch.core.fedeec  # noqa: F401


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

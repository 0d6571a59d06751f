"""EEC-NET tree topology (paper §II-A) with dynamic node migration.

The network G=(V,E) is a tree: one root (cloud), intermediate tiers (edges),
and leaves (end devices / clients). Node ids are strings; tiers are
1-indexed from the root (V_1={root}, V_T = leaves).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator

MigrateHook = Callable[[str, str, str], None]  # (node, old_parent, new_parent)


@dataclass
class Tree:
    root: str
    parent: dict[str, str] = field(default_factory=dict)  # child -> parent
    children: dict[str, list[str]] = field(default_factory=dict)
    # data-holding end devices (tier V_T). When set, this is authoritative:
    # an edge emptied by migration is a tree-leaf but NOT a device, and a
    # device stays a device however deep migrations push its tier.
    devices: set = field(default_factory=set, compare=False)
    _migrate_hooks: list = field(default_factory=list, repr=False, compare=False)

    # -- construction ------------------------------------------------------

    @staticmethod
    def three_tier(num_edges: int, num_clients: int, *, root: str = "cloud") -> "Tree":
        """cloud -> edges -> clients, clients distributed round-robin evenly
        (paper §V-B.2: devices evenly distributed across edge servers)."""
        t = Tree(root=root, children={root: []})
        for e in range(num_edges):
            t.add(f"edge{e}", root)
        for k in range(num_clients):
            t.add(f"client{k}", f"edge{k % num_edges}", device=True)
        return t

    def add(self, node: str, parent: str, *, device: bool = False) -> None:
        assert node not in self.parent and node != self.root, node
        assert parent == self.root or parent in self.parent, parent
        self.parent[node] = parent
        self.children.setdefault(parent, []).append(node)
        self.children.setdefault(node, [])
        if device:
            self.devices.add(node)

    # -- queries -----------------------------------------------------------

    @property
    def nodes(self) -> list[str]:
        return [self.root] + list(self.parent)

    def is_leaf(self, v: str) -> bool:
        return not self.children.get(v)

    @property
    def leaves(self) -> list[str]:
        return [v for v in self.nodes if self.is_leaf(v)]

    def leaf_set(self, v: str) -> list[str]:
        """Leaf(v): all leaves of the subtree rooted at v."""
        if self.is_leaf(v):
            return [v]
        out: list[str] = []
        for c in self.children[v]:
            out.extend(self.leaf_set(c))
        return out

    def tier(self, v: str) -> int:
        t = 1
        while v != self.root:
            v = self.parent[v]
            t += 1
        return t

    @property
    def num_tiers(self) -> int:
        return max(self.tier(v) for v in self.nodes)

    def tier_nodes(self, t: int) -> list[str]:
        return [v for v in self.nodes if self.tier(v) == t]

    def post_order(self) -> Iterator[str]:
        def rec(v):
            for c in self.children.get(v, []):
                yield from rec(c)
            yield v

        yield from rec(self.root)

    def validate(self) -> None:
        seen = set()
        for v in self.post_order():
            assert v not in seen, f"cycle at {v}"
            seen.add(v)
        assert seen == set(self.nodes)

    def is_device(self, v: str) -> bool:
        """Data-holding end device. Falls back to the leaf heuristic for
        hand-built trees that never marked devices."""
        return v in self.devices if self.devices else self.is_leaf(v)

    def path_to_root(self, v: str) -> list[str]:
        """Nodes from ``v`` (inclusive) up to and including the root."""
        out = [v]
        while v != self.root:
            v = self.parent[v]
            out.append(v)
        return out

    # -- dynamic migration (paper §IV-E) -------------------------------------

    def on_migrate(self, hook: MigrateHook) -> None:
        """Register a callback fired after every successful ``migrate`` —
        the simulator and trainers use this to observe re-parenting they
        did not initiate themselves (e.g. DemLearn's self-organization)."""
        self._migrate_hooks.append(hook)

    def migrate(self, node: str, new_parent: str) -> None:
        """Re-parent ``node`` under ``new_parent`` (Theorem 1: always legal
        under an equivalence interaction protocol). Refuses cycles."""
        assert node != self.root, "root cannot migrate"
        v = new_parent
        while v != self.root:
            assert v != node, f"migration of {node} under {new_parent} creates a cycle"
            v = self.parent[v]
        old = self.parent[node]
        self.children[old].remove(node)
        self.parent[node] = new_parent
        self.children.setdefault(new_parent, []).append(node)
        for hook in self._migrate_hooks:
            hook(node, old, new_parent)


def link_kind(tree: Tree, child: str) -> str:
    """Tier class of the link from ``child`` to its parent — the single
    rule shared by CommMeter accounting and NetworkModel pricing:
      "end-edge"   device <-> its parent (wherever migration put it)
      "edge-cloud" non-device <-> root (incl. an edge emptied mid-run)
      "other"      interior links of deeper hierarchies
    """
    if tree.is_device(child):
        return "end-edge"
    if tree.parent[child] == tree.root:
        return "edge-cloud"
    return "other"

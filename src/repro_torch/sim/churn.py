"""Node lifecycle + mobility processes, array-resident at scale.

The port's own copy of ``repro.sim.churn`` (numpy and the standard library
only); the two must stay identical in behaviour, which
``tests/test_torch_sim.py`` holds them to.

``ChurnProcess`` owns all randomness about *who misbehaves when*: which
leaves are stragglers (drawn once), who drops offline each round and for
how long, and who migrates to which edge (stochastic mobility or a
scripted ``TraceEntry`` replay). All draws come from one seeded
``default_rng`` iterated in sorted-node order, so the full churn history
is a deterministic function of (tree, scenario, seed).

Population state lives in NumPy arrays indexed by the name-sorted node
universe (devices + edges): ``_until[i]`` is node i's offline-until time
(``-inf`` = online, i.e. "no entry"), so the per-round rejoin sweep and
the stochastic dropout draws are O(population) array ops instead of
per-node Python loops over re-sorted dicts.

Bit-identical vectorization: the historical scalar loop interleaves one
``rng.random()`` decision per online node with one ``rng.uniform()``
offline-window draw per dropout — a data-dependent consumption pattern.
Both calls consume exactly one double from the generator, so the whole
interleaved sequence is a plain double stream; ``_interleaved_bernoulli``
decodes decision-vs-window positions from batched draws (windows sit at
odd offsets inside maximal runs of ``z < p``, plus a trailing window
after an odd-length run) and fetches exactly the doubles the scalar loop
would have consumed — the generator state afterwards, and therefore every
event signature, matches the per-node implementation bit-for-bit.

The process is round-indexed: the engine calls ``draw_round(r, now)`` at
each round boundary and gets back a list of actions to apply/log. Offline
windows are in simulated seconds, so a single outage can straddle several
rounds of a fast scenario or none of a slow one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.topology import Tree
from repro_torch.sim.scenarios import ScenarioConfig


@dataclass
class ChurnAction:
    kind: str  # dropout | rejoin | migrate
    node: str
    target: str = ""  # destination edge for migrate
    until: float = 0.0  # back-online time for dropout


def _window_mask(z: np.ndarray, p: float) -> np.ndarray:
    """Which positions of the raw double stream ``z`` are offline-window
    draws (vs Bernoulli decisions) under the interleaved pattern
    ``w[t+1] = ~w[t] & (z[t] < p)``, ``w[0] = False``. Within a maximal
    run of ``z < p`` starting at t0, windows sit at odd offsets
    (decisions at even offsets always succeed, so the next slot is their
    window); the slot just past an odd-length run is one more window."""
    f = z < p
    n = len(f)
    win = np.zeros(n, dtype=bool)
    if not f.any():
        return win
    t = np.arange(n)
    prev = np.empty(n, dtype=bool)
    prev[0] = False
    prev[1:] = f[:-1]
    run_start = np.maximum.accumulate(np.where(f & ~prev, t, -1))
    off = t - run_start
    win = f & ((off & 1) == 1)
    even_dec = f & ((off & 1) == 0)  # in-run decisions: always droppers
    win[1:] |= ~f[1:] & even_dec[:-1]  # trailing window of odd-length run
    return win


def _interleaved_bernoulli(rng: np.random.Generator, n: int, p: float):
    """Batched replay of the scalar loop ``for each of n nodes: z =
    rng.random(); if z < p: w = rng.uniform(...)``. Returns ``(drop,
    winz)``: ``drop[i]`` is node i's decision, ``winz[i]`` its window
    double (meaningful only where ``drop``). Draws are fetched
    incrementally — first n doubles, then exactly the shortfall each
    pass — so total generator consumption equals the scalar loop's."""
    z = rng.random(n)
    while True:
        win = _window_mask(z, p)
        dec = ~win
        c = int(dec.sum())
        pending = bool(dec[-1]) and bool(z[-1] < p)  # last drop, window undrawn
        if c == n and not pending:
            break
        z = np.concatenate([z, rng.random((n - c) + (1 if pending else 0))])
    pos = np.nonzero(dec)[0]
    drop = z[pos] < p
    winz = np.empty(n)
    winz[drop] = z[pos[drop] + 1]
    return drop, winz


class ChurnProcess:
    def __init__(self, tree: Tree, scenario: ScenarioConfig, seed: int = 0):
        self.tree = tree
        self.sc = scenario
        self.rng = np.random.default_rng(seed)
        # device/edge membership is fixed at construction: migration moves
        # devices around but an edge emptied mid-run is still an edge (and
        # still a valid migration target), not a device
        self.devices: list[str] = sorted(
            tree.devices or (v for v in tree.nodes if tree.is_leaf(v))
        )
        devset = set(self.devices)  # set probe: the list scan is O(n^2)
        self.edges: list[str] = sorted(
            v for v in tree.nodes
            if v != tree.root and v not in devset
        )
        # array-resident lifecycle state over the name-sorted universe:
        # ascending index order IS sorted-name order, so array sweeps
        # reproduce the historical sorted-dict iteration exactly
        self._names: list[str] = sorted(self.devices + self.edges)
        self._idx: dict[str, int] = {v: i for i, v in enumerate(self._names)}
        self._until = np.full(len(self._names), -np.inf)
        self._dev_idx = np.array([self._idx[v] for v in self.devices],
                                 dtype=np.int64)
        self._edge_idx = np.array([self._idx[v] for v in self.edges],
                                  dtype=np.int64)
        # nodes outside the universe (e.g. the root in a custom trace):
        # rare, kept in a dict so semantics stay exact
        self._extra: dict[str, float] = {}
        n_strag = int(round(scenario.straggler_frac * len(self.devices)))
        self._stragglers: set[str] = {
            str(v) for v in
            self.rng.choice(self.devices, size=n_strag, replace=False)
        } if n_strag else set()
        self._strag_sorted: list[str] = sorted(self._stragglers)

    # -- straggler population (sorted once; engine reads both views) -------

    @property
    def stragglers(self) -> set[str]:
        return self._stragglers

    @stragglers.setter
    def stragglers(self, value) -> None:
        self._stragglers = set(value)
        self._strag_sorted = sorted(self._stragglers)

    @property
    def stragglers_sorted(self) -> list[str]:
        """Name-sorted straggler list, maintained once at assignment —
        not re-sorted per consumer."""
        return self._strag_sorted

    # -- offline state accessors -------------------------------------------

    @property
    def offline_until(self) -> dict[str, float]:
        """Read-only snapshot of node -> back-online time (offline nodes
        only) — the historical dict view, rebuilt from the state array.
        Mutate through :meth:`force_offline` / :meth:`load_offline`."""
        return self.offline_map()

    def offline_map(self) -> dict[str, float]:
        out = {
            self._names[i]: float(self._until[i])
            for i in np.nonzero(self._until > -np.inf)[0]
        }
        out.update(self._extra)
        return out

    def load_offline(self, mapping: dict[str, float]) -> None:
        self._until.fill(-np.inf)
        self._extra.clear()
        for v, t in mapping.items():
            self._set_until(str(v), float(t))

    def force_offline(self, v: str, until: float) -> float:
        """Extend ``v``'s offline window to at least ``until`` (fault
        plane: outages, departures); returns the effective window end."""
        i = self._idx.get(v)
        if i is None:
            u = max(self._extra.get(v, 0.0), until)
            self._extra[v] = u
        else:
            u = max(float(self._until[i]), until)
            self._until[i] = u
        return u

    def next_rejoin_after(self, now: float):
        """Earliest offline-window end strictly past ``now``, or None —
        the idle-clock target when a round has nothing to schedule."""
        pending = self._until[self._until > now]
        best = float(pending.min()) if pending.size else None
        for t in self._extra.values():
            if t > now and (best is None or t < best):
                best = t
        return best

    def _set_until(self, v: str, until: float) -> None:
        i = self._idx.get(v)
        if i is None:
            self._extra[v] = until
        else:
            self._until[i] = until

    def _clear(self, v: str) -> None:
        i = self._idx.get(v)
        if i is None:
            self._extra.pop(v, None)
        else:
            self._until[i] = -np.inf

    # -- queries -----------------------------------------------------------

    def is_online(self, v: str, now: float) -> bool:
        i = self._idx.get(v)
        if i is None:
            return self._extra.get(v, -np.inf) <= now if self._extra else True
        return bool(self._until[i] <= now)

    def online_devices(self, now: float) -> list[str]:
        """Currently-online device names (one array sweep, name-sorted)."""
        sel = np.nonzero(self._until[self._dev_idx] <= now)[0]
        return [self.devices[i] for i in sel]

    def offline_set(self, now: float) -> set[str]:
        """Names offline at ``now`` — one array sweep; membership in the
        result is the batched form of :meth:`is_online` (the per-call
        form costs a dict probe + array index that round hot paths with
        10^4+ participants cannot afford per node)."""
        out = {self._names[i] for i in np.nonzero(self._until > now)[0]}
        if self._extra:
            out.update(v for v, t in self._extra.items() if t > now)
        return out

    def compute_factor(self, v: str) -> float:
        return self.sc.straggler_slowdown if v in self._stragglers else 1.0

    def _other_edge(self, v: str) -> str | None:
        cur = self.tree.parent[v]
        options = [e for e in self.edges if e != cur]
        if not options:
            return None
        return options[int(self.rng.integers(len(options)))]

    # -- per-round draw ----------------------------------------------------

    def _stochastic_dropouts(self, idxs: np.ndarray, prob: float,
                             now: float, actions: list) -> None:
        """Steps 3/4: one Bernoulli(prob) decision per ONLINE node of
        ``idxs`` in index (= name-sorted) order, each dropout consuming
        one extra uniform window draw — decoded from batched doubles with
        generator consumption identical to the scalar loop."""
        sub = idxs[self._until[idxs] <= now]
        n = len(sub)
        if n == 0:
            return
        drop, winz = _interleaved_bernoulli(self.rng, n, prob)
        hit = np.nonzero(drop)[0]
        if not hit.size:
            return
        lo, hi = self.sc.dropout_s
        untils = now + (lo + (hi - lo) * winz[hit])  # == now + uniform(lo, hi)
        self._until[sub[hit]] = untils
        names = self._names
        for i, u in zip(sub[hit], untils):
            actions.append(ChurnAction("dropout", names[i], until=float(u)))

    def draw_round(self, r: int, now: float) -> list[ChurnAction]:
        sc = self.sc
        actions: list[ChurnAction] = []

        # 1. rejoins: offline windows that expired before this round —
        # ascending-index sweep == the historical sorted(offline_until)
        expired = np.nonzero((self._until > -np.inf)
                             & (self._until <= now))[0]
        if expired.size or self._extra:
            names = [self._names[i] for i in expired]
            extra = sorted(v for v, t in self._extra.items() if t <= now)
            if extra:
                names = sorted(names + extra)
                for v in extra:
                    del self._extra[v]
            self._until[expired] = -np.inf
            for v in names:
                actions.append(ChurnAction("rejoin", v))

        # 2. scripted trace for this round (deterministic, consumes no rng)
        for e in sc.trace:
            if e.round != r:
                continue
            if e.kind == "dropout":
                until = now + e.duration_s
                self._set_until(e.node, until)
                actions.append(ChurnAction("dropout", e.node, until=until))
            elif e.kind == "migrate":
                actions.append(ChurnAction("migrate", e.node, target=e.target))
            elif e.kind == "rejoin":
                self._clear(e.node)
                actions.append(ChurnAction("rejoin", e.node))
            else:
                raise ValueError(f"unknown trace kind {e.kind!r}")

        # 3. stochastic edge outages / 4. stochastic leaf dropouts
        self._stochastic_dropouts(self._edge_idx, sc.edge_dropout_prob,
                                  now, actions)
        self._stochastic_dropouts(self._dev_idx, sc.dropout_prob,
                                  now, actions)

        # 5. mobility: stochastic per-leaf re-parenting. Stays scalar:
        # the target draw (`rng.integers`) uses bounded-integer rejection
        # sampling whose consumption cannot be replayed from a double
        # block, and the historical stream interleaves it per node.
        if sc.migration_prob > 0:
            for v in self.devices:  # analysis: allow[PERF001] rng-order compat
                if not self.is_online(v, now):
                    continue
                if self.rng.random() < sc.migration_prob:
                    tgt = self._other_edge(v)
                    if tgt is not None:
                        actions.append(ChurnAction("migrate", v, target=tgt))

        # 6. scripted mass migration
        if r == sc.mass_migration_round and sc.mass_migration_frac > 0:
            leaves = self.devices
            k = max(1, int(round(sc.mass_migration_frac * len(leaves))))
            moved = [str(v) for v in
                     self.rng.choice(leaves, size=min(k, len(leaves)),
                                     replace=False)]
            for v in sorted(moved):
                if not self.is_online(v, now):
                    continue
                tgt = self._other_edge(v)
                if tgt is not None:
                    actions.append(ChurnAction("migrate", v, target=tgt))

        return actions

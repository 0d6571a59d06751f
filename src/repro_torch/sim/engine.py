"""Event-driven FL rounds over the discrete-event simulator, counterpart
of ``repro.sim.engine``.

Every trainer is an ``FLAlgorithm`` (``repro_torch.fl.api``): a round is the
dependency graph of the trainer's ``WorkItem``s. An item keyed on node v
may start only after every scheduled item whose ``peer`` is v has
finished — for FedEEC's BSBODP pairs that is the post-order
subtree-before-parent rule, for the aggregation baselines it makes each
edge's aggregation wait for its clients' local steps — and a node
serializes the items it participates in. Item duration =

    compute  : steps x base_step_s x (straggler/tier factors, per kind)
    comm     : CommMeter-recorded bytes of the item / link bandwidth
               + link latency        (repro_torch.sim.network)

so a round's simulated length is its critical path through the tree —
stragglers and slow links stretch it, parallel subtrees don't. Churn
actions (dropout / rejoin / migrate) fire at round boundaries; offline
nodes' items are skipped (removing baseline clients from the round's
aggregation weights, not just its clock), and migrations are charged
their re-registration bytes *and* transfer time. Migration legality is
decided by the trainer's declared interaction protocol (§IV-E,
Theorems 1-2): a refused move is logged as ``migrate_refused`` with
``reason="protocol"`` and the topology is left untouched.

The engine is host numpy and the standard library: only the trainer's
``execute`` touches the card. It follows the reference's arithmetic step
for step, so the event log, and its signature, is bit-identical to the
reference's for the same trainer schedule. Dispatch goes through
``plan_groups`` as in the reference: items whose ``batch_signature``
compares equal and that share no participant run as one
``execute_batch`` call (FedEEC's coalesced pairs); a ``None`` signature
runs alone. ``save_checkpoint`` / ``restore_checkpoint`` snapshot every
stream a round consumes, in the reference's files (``trainer.msgpack``,
``engine.json``), so a resumed run is bit-identical to an uninterrupted
one and either package resumes the other's snapshot. A ``tracer``
(``repro_torch.obs.trace.Tracer``) records the reference's spans — round,
churn, dispatch group, execute, one ``item`` span per priced item, eval —
outside the event log: a traced run takes the general pricing loop, which
prices a fault-free item exactly as the fast path does, so its log, ``ord``s
included, is the untraced run's.
"""
from __future__ import annotations

import bisect
from contextlib import nullcontext
from typing import Callable, Optional

from repro_torch.core.topology import link_kind
from repro_torch.fl.api import FLAlgorithm, MigrationRefused, WorkItem
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.sim.churn import ChurnProcess
from repro_torch.sim.events import EventLog, EventQueue
from repro_torch.sim.faults import AttemptSchedule, FaultPlan, FaultProcess
from repro_torch.sim.network import NetworkModel
from repro_torch.sim.scenarios import ScenarioConfig

# event kinds that resolve a scheduled item and release its dependents —
# the degradation contract: a faulted item still unblocks its parent (at
# the instant its fate is sealed), so the dependency graph never deadlocks
TERMINAL_KINDS = ("pair_done", "pair_abandoned", "pair_timeout")


def plan_groups(items, signature_of):
    """Partition work items enabled at the same sim instant into dispatch
    groups, preserving serial scheduling semantics exactly.

    An item joins the FIRST existing group such that (a) the group's
    signature equals the item's, and (b) the item conflicts — shares a
    participant (node or peer; the empty peer "" counts, mirroring the
    scheduler's shared ``ready[""]`` slot) — with no member of that group
    *nor of any later group*. Otherwise it opens a new group at the end.
    Groups dispatch in creation order, so clause (b) guarantees every item
    runs after all earlier-enabled items it serializes behind: conflicting
    items always land in strictly increasing groups, and per-item start
    times computed group-by-group reproduce the serial schedule exactly.
    ``signature_of(item) -> None`` forces a singleton group.

    Implementation: clause (b) — "conflicts with no group >= gi" — is
    equivalent to ``gi > L`` where L is the LAST group index holding any
    of the item's participants (conflicting groups can only be <= L, and
    every group <= L holding a participant conflicts). So the first
    admissible group is the first sig-matching index past L: one dict
    lookup per participant plus a bisect over that signature's ascending
    group-index list — O(log) per item instead of rescanning all groups,
    with output provably identical to the quadratic scan.
    """
    groups: list[list] = []
    last_group: dict[str, int] = {}  # participant -> last group holding it
    by_sig: dict = {}  # signature -> ascending indices of its groups
    for it in items:
        sig = signature_of(it)
        gi = -1
        if sig is not None:
            threshold = max(last_group.get(it.node, -1),
                            last_group.get(it.peer, -1))
            cand = by_sig.get(sig)
            if cand is not None:
                j = bisect.bisect_right(cand, threshold)
                if j < len(cand):
                    gi = cand[j]
        if gi < 0:
            gi = len(groups)
            groups.append([it])
            if sig is not None:
                by_sig.setdefault(sig, []).append(gi)
        else:
            groups[gi].append(it)
        last_group[it.node] = gi
        last_group[it.peer] = gi
    return groups


class SimEngine:
    def __init__(
        self,
        trainer: FLAlgorithm,
        scenario: ScenarioConfig,
        *,
        seed: int = 0,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        faults: Optional[FaultPlan] = None,
        profile: bool = False,
    ):
        self.trainer = trainer
        self.tree = trainer.tree
        self.sc = scenario
        self.net = NetworkModel(
            self.tree,
            end_edge=scenario.end_edge,
            edge_cloud=scenario.edge_cloud,
            other=scenario.other,
            seed=seed + 1,
        )
        self.churn = ChurnProcess(self.tree, scenario, seed=seed + 2)
        # weighted cohorts (docs/simulator.md): a declared population
        # larger than the materialized tree trains one representative
        # device per homogeneous cohort; cohort sizes multiply the
        # trainer's aggregation weights (exact for homogeneous cohorts)
        if scenario.population:
            devs = self.churn.devices
            if scenario.population < len(devs):
                raise ValueError(
                    f"scenario {scenario.name!r} declares population "
                    f"{scenario.population} smaller than the materialized "
                    f"tree's {len(devs)} devices")
            base, rem = divmod(scenario.population, len(devs))
            trainer.set_cohort_sizes(
                {v: base + (1 if i < rem else 0)
                 for i, v in enumerate(devs)})
        self._fair_share = bool(scenario.fair_share)
        # node -> link tier, invalidated on migration (a device's tier
        # never changes, but a re-parented interior node's can)
        self._lk_cache: dict[str, str] = {}
        # fault plane (docs/robustness.md): an explicit ``faults`` plan
        # overrides the scenario's; an absent or inactive plan keeps the
        # engine on the fault-free path — no fault stream is ever touched
        # and signatures match pre-fault builds bit-for-bit
        self.fault_plan = faults if faults is not None else scenario.faults
        self.faults = (
            FaultProcess(self.tree, self.fault_plan, seed=seed + 3)
            if self.fault_plan is not None and self.fault_plan.active()
            else None
        )
        self.queue = EventQueue()
        self.log = EventLog()
        self.now = 0.0
        self.acc_points: list[tuple[float, float]] = []  # (sim_s, acc)
        # host seconds of each round's work (run()), outside the event log
        self.round_s: list[float] = []
        self._round_next = 0  # first round run() will execute (resume point)
        self._in_migrate = False
        # log migrations initiated by the trainer itself (e.g. DemLearn's
        # self-organizing re-clustering), not just by the churn process
        self.tree.on_migrate(self._external_migration)
        trainer.on_migrate_refused(self._external_refusal)
        # telemetry plane: the tracer and registry live OUTSIDE the event
        # log, whose signature must stay bit-identical whether or not they
        # are attached
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # host-side phase profiling (--profile-sim): per-phase wall-clock
        # accumulators surfaced as gauges after run(). Host-only — the
        # timings never touch the event log, so signatures are unchanged
        # whether profiling is on or off.
        self._prof: dict[str, float] | None = {} if profile else None
        for name in ("sim_dispatch_items_total", "sim_dispatches_total",
                     "sim_batched_dispatches_total",
                     "sim_batched_items_total", "sim_migrate_refused_total",
                     "sim_migrations_total", "sim_dropouts_total",
                     "sim_rejoins_total", "sim_transfer_failures_total",
                     "sim_transfer_retries_total",
                     "sim_pairs_abandoned_total", "sim_pair_timeouts_total",
                     "sim_departures_total", "sim_regional_outages_total",
                     "sim_link_flaps_total", "sim_checkpoints_total"):
            self.metrics.counter(name)
        self.metrics.histogram("sim_queue_depth",
                               buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self.metrics.histogram("sim_round_duration_seconds",
                               buckets=(1, 5, 15, 60, 300, 1800))
        # straggler list is maintained sorted by the churn process (set
        # once at assignment), not re-sorted per consumer
        for v in self.churn.stragglers_sorted:
            self.metrics.gauge("sim_straggler_compute_factor", node=v).set(
                scenario.straggler_slowdown)
            self.log.note(0.0, "straggle", node=v,
                          slowdown=scenario.straggler_slowdown)

    @property
    def dispatch_stats(self) -> dict[str, int]:
        """Pair-coalescing counters (items vs actual dispatches) — a thin
        compatibility view over the metrics registry."""
        c = self.metrics.counter
        return {
            "items": int(c("sim_dispatch_items_total").value),
            "dispatches": int(c("sim_dispatches_total").value),
            "batched_dispatches": int(c("sim_batched_dispatches_total").value),
            "batched_items": int(c("sim_batched_items_total").value),
        }

    # -- hooks -------------------------------------------------------------

    def _external_migration(self, node: str, old: str, new: str) -> None:
        self._lk_cache.pop(node, None)
        if not self._in_migrate:
            self.log.note(self.now, "migrate", node=node, target=new,
                          source="trainer")

    def _external_refusal(self, node: str, target: str, reason: str) -> None:
        if not self._in_migrate:
            self.metrics.counter("sim_migrate_refused_total").inc()
            self.log.note(self.now, "migrate_refused", node=node,
                          target=target, reason=reason, source="trainer")

    # -- churn application -------------------------------------------------

    def _apply_migration(self, node: str, target: str) -> tuple[float, float]:
        """Re-parent ``node`` and return the simulated transfer time of the
        embedding re-registration up the new path. Raises
        ``MigrationRefused`` when the trainer's protocol forbids the move."""
        self._in_migrate = True
        try:
            with self.trainer.comm.span() as sp:
                self.trainer.migrate(node, target)
            nbytes = sum(sp.by_link.values())
        finally:
            self._in_migrate = False
        return self.net.transfer_s(node, nbytes), nbytes

    def _round_churn(self, r: int) -> dict[str, float]:
        """Apply and log this round's churn; returns node -> busy-until
        times for nodes delayed by migration transfers."""
        busy: dict[str, float] = {}
        m = self.metrics.counter
        for act in self.churn.draw_round(r, self.now):
            if act.kind == "migrate":
                if act.target not in self.tree.nodes or \
                        act.node not in self.tree.parent:
                    m("sim_migrate_refused_total").inc()
                    self.log.note(self.now, "migrate_refused", node=act.node,
                                  target=act.target)
                    continue
                if self.tree.parent[act.node] == act.target:
                    continue
                try:
                    dur, nbytes = self._apply_migration(act.node, act.target)
                except MigrationRefused:
                    # Theorem 2: the interaction protocol forbids the move
                    m("sim_migrate_refused_total").inc()
                    self.log.note(self.now, "migrate_refused", node=act.node,
                                  target=act.target, reason="protocol")
                    continue
                busy[act.node] = max(busy.get(act.node, 0.0), self.now + dur)
                if self.tracer is not None:
                    self.tracer.add_span(
                        "migrate", cat="churn", node=act.node,
                        sim_t0=self.now, sim_t1=self.now + dur,
                        round=r, target=act.target, bytes=nbytes,
                    )
                m("sim_migrations_total").inc()
                self.log.note(self.now, "migrate", node=act.node,
                              target=act.target, bytes=nbytes,
                              dur=round(dur, 6))
            elif act.kind == "dropout":
                m("sim_dropouts_total").inc()
                self.log.note(self.now, "dropout", node=act.node,
                              until=round(act.until, 6))
                if self.tracer is not None:
                    self.tracer.add_span(
                        "offline", cat="churn", node=act.node,
                        sim_t0=self.now, sim_t1=act.until, round=r,
                    )
            elif act.kind == "rejoin":
                m("sim_rejoins_total").inc()
                self.log.note(self.now, "rejoin", node=act.node)
                if self.tracer is not None:
                    self.tracer.instant("rejoin", sim_t=self.now,
                                        node=act.node)
        if self.faults is not None:
            self._round_faults(r)
        return busy

    def _round_faults(self, r: int) -> None:
        """Apply this round's regional outages and link flaps. Outages
        write into ``churn.offline_until`` — the edge and all its current
        children drop together, and the churn process's ordinary rejoin
        sweep recovers them when the window expires."""
        m = self.metrics.counter
        for fa in self.faults.draw_round(r, self.now, self.churn.is_online):
            if fa.kind == "outage":
                m("sim_regional_outages_total").inc()
                self.log.note(self.now, "outage", node=fa.node,
                              until=round(fa.until, 6),
                              members=len(fa.members))
                for v in (fa.node,) + fa.members:
                    until = self.churn.force_offline(v, fa.until)
                    m("sim_dropouts_total").inc()
                    self.log.note(self.now, "dropout", node=v,
                                  until=round(until, 6))
                    if self.tracer is not None:
                        self.tracer.add_span(
                            "offline", cat="churn", node=v,
                            sim_t0=self.now, sim_t1=until, round=r,
                        )
            elif fa.kind == "flap":
                m("sim_link_flaps_total").inc()
                self.log.note(self.now, "link_flap", node=fa.node,
                              until=round(fa.until, 6))
                if self.tracer is not None:
                    self.tracer.instant("link_flap", sim_t=self.now,
                                        node=fa.node)

    # -- work-item round ---------------------------------------------------

    def _link_kind_of(self, node: str) -> str:
        lk = self._lk_cache.get(node)
        if lk is None:
            lk = self._lk_cache[node] = link_kind(self.tree, node)
        return lk

    def _item_compute_s(self, item: WorkItem) -> float:
        sc = self.sc
        if item.kind == "pair":
            # both directions of BSBODP run `steps` distillation steps
            f_child = self.churn.compute_factor(item.node)
            f_parent = self.churn.compute_factor(item.peer) / sc.tier_speedup
            return item.steps * sc.base_step_s * (f_child + f_parent)
        if item.kind == "local":
            return item.steps * sc.base_step_s * self.churn.compute_factor(item.node)
        # "aggregate" runs on an interior tier: fast, step-count cheap
        return item.steps * sc.base_step_s / sc.tier_speedup

    def _item_straggle(self, item: WorkItem) -> tuple[float, str]:
        """(compute factor, straggling participant) of the slowest
        participant — trace attribution only, never priced here."""
        f_node = self.churn.compute_factor(item.node)
        f_peer = self.churn.compute_factor(item.peer) if item.peer else 1.0
        if f_peer > f_node:
            return f_peer, item.peer
        if f_node > 1.0:
            return f_node, item.node
        return 1.0, ""

    def _run_round_items(self, r: int, busy: dict[str, float]) -> None:
        """Schedule the trainer's work items through their dependency
        graph; the round ends when the critical path drains."""
        tree, q = self.tree, self.queue
        prof = self._prof
        if prof is not None:
            from time import perf_counter
            _p0 = perf_counter()  # analysis: allow[DET001] host-only profiling
        t0 = self.now
        # one array sweep instead of a per-participant is_online probe
        offline = self.churn.offline_set(t0)
        online = lambda v: v not in offline
        if self._fair_share:
            # rounds are barriers: no transfer spans a round boundary, so
            # contention bookkeeping restarts with each round's schedule
            self.net.reset_contention()

        self.trainer.begin_round(r)
        items: list[WorkItem] = []
        add = items.append
        for it in self.trainer.work_items(r, online):
            if it.node not in offline and (
                    not it.peer or it.peer not in offline):
                add(it)
            else:
                self.log.note(t0, "pair_skip", node=it.node, target=it.peer,
                              offline=(it.node if it.node in offline
                                       else it.peer))
        if not items:
            # every item skipped (e.g. all edges down): idle until the
            # earliest offline window expires so nodes can rejoin — without
            # this the clock freezes and the outage never ends
            nxt = self.churn.next_rejoin_after(t0)
            self.now = nxt if nxt is not None else t0 + self.sc.base_step_s
            self.log.note(self.now, "idle", reason="no schedulable pairs")
            self.trainer.end_round(r)
            return

        scheduled: dict[str, WorkItem] = {}
        for it in items:
            if it.node in scheduled:
                # the dependency graph is keyed by node: one item per node
                # per round (an async policy wanting more must split rounds)
                raise ValueError(
                    f"duplicate work item for node {it.node!r} in round {r}; "
                    "the scheduler runs one item per node per round"
                )
            scheduled[it.node] = it
        # the item on v waits for every scheduled item feeding v (peer == v)
        children = tree.children
        deps: dict[str, int] = {}
        for it in items:
            kids = children.get(it.node)
            deps[it.node] = (
                sum(1 for c in kids if c in scheduled) if kids else 0)
        ready = dict(busy)  # node -> time it becomes free
        if prof is not None:
            _pc = perf_counter  # analysis: allow[DET001] host-only profiling
            prof["schedule"] = prof.get("schedule", 0.0) + _pc() - _p0

        def dispatch(enabled: list[WorkItem], t_en: float) -> None:
            """Execute the items that became dependency-free at sim instant
            ``t_en``, coalescing same-signature independent items into one
            ``execute_batch`` call. Start times are computed per group in
            creation order (so ``ready`` serialization matches the serial
            schedule exactly), and events are pushed in the ORIGINAL item
            order — the queue's (time, seq) assignment, and therefore the
            log signature, is bit-identical to one-item-at-a-time dispatch.
            Bookkeeping is keyed by item identity (``id``): value-hashing a
            WorkItem several times per item is measurable at 10^4 items per
            instant, and the scheduler already guarantees items are unique
            (one per node per round).
            """
            if prof is not None:
                _d0 = _pc()
            groups = plan_groups(enabled, self.trainer.batch_signature)
            counter = self.metrics.counter
            counter("sim_dispatch_items_total").inc(len(enabled))
            counter("sim_dispatches_total").inc(len(groups))
            tr = self.tracer
            timed: dict[int, tuple[float, list]] = {}  # id(item) -> result
            # fast-path results keep a flat (start, end, done-payload)
            # record instead of the general event list — no nested tuples
            fast: dict[int, tuple[float, float, dict]] = {}
            link_pend: dict[str, float] = {}  # fast-path per-tier byte sums
            rget = ready.get
            link_ctrs: dict[str, object] = {}  # link tier -> bytes counter
            for group in groups:
                starts = [
                    max(t_en, rget(it.node, t0), rget(it.peer, t0), t0)
                    for it in group
                ]
                comps = [self._item_compute_s(it) for it in group]
                # fail-fast fault model: every attempt's fate is decided at
                # its start from compute + backoff times alone, so doomed
                # items are known BEFORE execution and never run — there is
                # no FedEEC/SKR state to roll back (docs/robustness.md)
                scheds: list[AttemptSchedule] | None = None
                live = group
                if self.faults is not None:
                    scheds = [
                        self.faults.plan_attempts(it.node, start, comp)
                        for it, start, comp in zip(group, starts, comps)
                    ]
                    for sched in scheds:
                        counter("sim_transfer_failures_total").inc(
                            sched.failures)
                        counter("sim_transfer_retries_total").inc(
                            sched.retries)
                    live = [it for it, sched in zip(group, scheds)
                            if sched.outcome == "ok"]
                with (tr.span("dispatch_group", cat="dispatch",
                              n_items=len(group), round=r)
                      if tr is not None else nullcontext()):
                    with (tr.span("execute_batch" if len(live) > 1
                                  else "execute", cat="execute",
                                  n_items=len(live))
                          if tr is not None else nullcontext()) as es, \
                            self.trainer.comm.span() as sp:
                        if len(live) == 1:
                            self.trainer.execute(live[0])
                        elif live:
                            self.trainer.execute_batch(live)
                            counter("sim_batched_dispatches_total").inc()
                            counter("sim_batched_items_total").inc(len(live))
                    total = sum(sp.by_link.values())
                    # same-signature items record identical traffic, so the
                    # even split is exact; floor division keeps the serial
                    # sum's type (int stays int, float stays float — a type
                    # flip would change the JSON byte payloads and break
                    # signature identity)
                    nbytes = total // len(live) if live else 0
                    host_each = (es.host_dur / len(live)
                                 if tr is not None and live else 0.0)
                    if scheds is None and tr is None:
                        # fault-free, untraced fast path: identical math
                        # and event payloads to the general loop below,
                        # with the per-item branch ladder stripped and the
                        # transfer-pricing / link-kind / byte-counter calls
                        # inlined or deferred (their function-call overhead
                        # alone is measurable at 10^5 events/s) — this loop
                        # prices every item of every round at scale
                        shared_xfer = self.net.transfer_shared_s
                        eff_get = self.net._eff.get  # see network.py cache
                        eff_miss = self.net._effective
                        lkc_get = self._lk_cache.get
                        lk_of = self._link_kind_of
                        lp_get = link_pend.get
                        fair = self._fair_share
                        for it, start, comp in zip(group, starts, comps):
                            node = it.node
                            t_ok = start + comp
                            if fair:
                                end = t_ok + shared_xfer(node, nbytes, t_ok)
                            elif nbytes > 0:
                                eff = eff_get(node) or eff_miss(node)
                                end = t_ok + eff[0] + nbytes / eff[1]
                            else:
                                end = t_ok
                            lk = lkc_get(node)
                            if lk is None:
                                lk = lk_of(node)
                            link_pend[lk] = lp_get(lk, 0) + nbytes
                            ready[node] = ready[it.peer] = end
                            fast[id(it)] = (start, end, {
                                "bytes": nbytes,
                                "dur": round(end - start, 6)})
                        continue
                    # the general loop: faults (every item carries its
                    # attempt schedule) or a tracer (one span per item)
                    for gi, (it, start, comp) in enumerate(
                            zip(group, starts, comps)):
                        sched = scheds[gi] if scheds is not None else None
                        evs = list(sched.events) if sched is not None else []
                        if sched is None or sched.outcome == "ok":
                            # with retries, transfer begins at the first
                            # successful attempt (sched.t_final), not at
                            # start + comp — backoff waits are the retry tax
                            t_ok = (start + comp if sched is None
                                    else sched.t_final)
                            xfer = (self.net.transfer_shared_s(
                                        it.node, nbytes, t_ok)
                                    if self._fair_share
                                    else self.net.transfer_s(
                                        it.node, nbytes))
                            end = t_ok + xfer
                            dur = end - start
                            lk = link_kind(self.tree, it.node)
                            ctr = link_ctrs.get(lk)
                            if ctr is None:
                                ctr = link_ctrs[lk] = counter(
                                    "sim_link_bytes_total", link=lk)
                            ctr.inc(nbytes)
                            if tr is not None:
                                factor, slow = self._item_straggle(it)
                                tr.add_span(
                                    f"{it.kind} {it.node}->{it.peer}",
                                    cat="item", node=it.node,
                                    sim_t0=start, sim_t1=end,
                                    host_dur=host_each, kind=it.kind,
                                    peer=it.peer, round=r, bytes=nbytes,
                                    compute_s=round(comp, 6),
                                    transfer_s=round(xfer, 6),
                                    straggle=factor, straggle_node=slow,
                                    retries=(sched.retries if sched else 0),
                                    retry_wait_s=round(
                                        sched.retry_wait_s if sched else 0.0,
                                        6),
                                )
                            done = {"bytes": nbytes, "dur": round(dur, 6)}
                            if sched is not None and sched.retries:
                                done["retries"] = sched.retries
                            evs.append((end, "pair_done", done))
                        else:
                            end = sched.t_final
                            self._item_failed(it, sched, r, start)
                        ready[it.node] = ready[it.peer] = end
                        timed[id(it)] = (start, evs)
            # one counter bump per link tier per dispatch, not per item —
            # the sums are what the counters hold, so totals are identical
            for lk, nb in link_pend.items():
                ctr = link_ctrs.get(lk)
                if ctr is None:
                    ctr = link_ctrs[lk] = counter(
                        "sim_link_bytes_total", link=lk)
                ctr.inc(nb)
            push = q.push_payload
            push_pair = q.push_pair
            fget = fast.get
            for it in enabled:
                f = fget(id(it))
                if f is not None:
                    push_pair(f[0], f[1], it.node, it.peer, f[2])
                    continue
                start, evs = timed[id(it)]
                push(start, "pair_start", it.node, it.peer, {})
                for t_ev, kind, payload in evs:
                    push(t_ev, kind, it.node, it.peer, payload)
            if prof is not None:
                prof["dispatch"] = prof.get("dispatch", 0.0) + _pc() - _d0

        dispatch([it for it in items if deps[it.node] == 0], t0)

        depth_hist = self.metrics.histogram("sim_queue_depth")
        log_batch = self.log.append_batch
        terminal = frozenset(TERMINAL_KINDS)
        if prof is not None:
            _w0, _wd0 = _pc(), prof.get("dispatch", 0.0)
        while q:
            # drain every event at the earliest queued instant before
            # dispatching what they enabled: pops never push, so deferring
            # the pushes keeps seq assignment identical to serial dispatch
            # while exposing same-time-enabled items for coalescing. The
            # depth is observed BEFORE the pop, batch included — matching
            # the historical one-pop-at-a-time instrumentation.
            depth_hist.observe(len(q))
            batch = q.pop_batch()
            t = batch[0].time
            if t > self.now:
                self.now = t
            # log first, then walk dependencies: nothing writes to the log
            # between the first and last event of a batch (notes only come
            # from dispatch, which runs after), so entry order is identical
            # to the historical append-as-you-go loop
            log_batch(batch)
            enabled: list[WorkItem] = []
            for ev in batch:
                # graceful degradation: a faulted item (abandoned/timeout)
                # still releases its parent, which proceeds on the partial
                # inputs that DID arrive — the graph drains, never deadlocks
                if ev.kind not in terminal:
                    continue
                parent = ev.target
                if parent not in scheduled:
                    continue
                deps[parent] -= 1
                if deps[parent] == 0:
                    enabled.append(scheduled[parent])
            if enabled:
                dispatch(enabled, t)
        if prof is not None:
            # drain = queue pops + log appends + dependency walks; the
            # dispatches the loop triggered are attributed to "dispatch"
            prof["drain"] = prof.get("drain", 0.0) + (
                _pc() - _w0) - (prof.get("dispatch", 0.0) - _wd0)

        self.trainer.end_round(r)

    def _item_failed(self, it: WorkItem, sched: AttemptSchedule, r: int,
                     start: float) -> None:
        """Account for an item whose every transfer attempt failed: bump
        the fault counters, take a departed node offline (the churn
        process's rejoin sweep recovers it), and notify the trainer so the
        loss is excluded from aggregation weights."""
        m = self.metrics.counter
        if sched.outcome == "timeout":
            m("sim_pair_timeouts_total").inc()
        else:
            m("sim_pairs_abandoned_total").inc()
        if sched.outcome == "departed":
            m("sim_departures_total").inc()
            self.churn.force_offline(it.node, sched.offline_until)
        if self.tracer is not None:
            self.tracer.add_span(
                f"{it.kind} {it.node}->{it.peer} [{sched.outcome}]",
                cat="item", node=it.node,
                sim_t0=start, sim_t1=sched.t_final,
                kind=it.kind, peer=it.peer, round=r, bytes=0,
                outcome=sched.outcome, retries=sched.retries,
                retry_wait_s=round(sched.retry_wait_s, 6),
            )
        self.trainer.on_item_failed(it, sched.outcome)

    # -- run loop ----------------------------------------------------------

    def run(
        self,
        rounds: int,
        *,
        eval_fn: Optional[Callable[[], float]] = None,
        eval_every: int = 1,
        checkpoint_every: int = 0,
        checkpoint_path: str = "",
        stop_after: Optional[int] = None,
        sync: Optional[Callable[[], None]] = None,
    ) -> EventLog:
        """Run rounds ``[self._round_next, rounds)``. A fresh engine starts
        at round 0; one restored via :meth:`restore_checkpoint` continues
        where the snapshot left off, its event signature bit-identical to
        an uninterrupted run's. ``checkpoint_every`` > 0 snapshots to
        ``checkpoint_path`` after every N-th round; ``stop_after`` ends the
        run after that many total rounds WITHOUT the final-round eval
        (simulating a kill mid run). Each round's host seconds, from its
        start to the end of its work (churn and items, before its eval), go
        to ``self.round_s``, outside the event log; ``sync``, when given, is
        called at the end of each round's work, inside that time (e.g. a
        device synchronize). Under a tracer the ``round r`` span encloses
        that same interval (churn, items and ``sync``), and the eval is an
        ``eval`` span of its own."""
        from time import perf_counter

        tr = self.tracer
        prof = self._prof
        if prof is not None:
            _r0 = perf_counter()  # analysis: allow[DET001] host-only profiling
            _ev0 = len(self.log.entries)
        for r in range(self._round_next, rounds):
            t_start = self.now
            self.log.note(self.now, "round_start", round=r)
            with (tr.span(f"round {r}", cat="round", sim_t0=self.now,
                          round=r)
                  if tr is not None else nullcontext()) as rsp:
                _h0 = perf_counter()  # analysis: allow[DET001] host-only timing
                with (tr.span("churn", cat="churn", sim_t0=self.now,
                              round=r)
                      if tr is not None else nullcontext()) as csp:
                    if prof is not None:
                        _c0 = perf_counter()  # analysis: allow[DET001]
                    busy = self._round_churn(r)
                    if prof is not None:
                        prof["churn"] = (prof.get("churn", 0.0)
                                         + perf_counter() - _c0)  # analysis: allow[DET001]
                    if tr is not None:
                        csp.sim_t1 = self.now
                self.trainer.set_participation(
                    self.churn.online_devices(self.now))
                self._run_round_items(r, busy)
                if sync is not None:
                    sync()
                self.round_s.append(perf_counter() - _h0)  # analysis: allow[DET001]
                if tr is not None:
                    rsp.sim_t1 = self.now
            self.metrics.histogram("sim_round_duration_seconds").observe(
                self.now - t_start)
            self.log.note(self.now, "round_end", round=r)
            self._round_next = r + 1
            if eval_fn and ((r + 1) % eval_every == 0 or r == rounds - 1):
                with (tr.span("eval", cat="eval", round=r)
                      if tr is not None else nullcontext()):
                    if prof is not None:
                        _e0 = perf_counter()  # analysis: allow[DET001]
                    acc = eval_fn()
                    if prof is not None:
                        prof["eval"] = (prof.get("eval", 0.0)
                                        + perf_counter() - _e0)  # analysis: allow[DET001]
                self.acc_points.append((round(self.now, 6), acc))
                self.log.note(self.now, "eval", round=r, acc=round(acc, 6))
            if checkpoint_every > 0 and checkpoint_path and \
                    (r + 1) % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_path)
            if stop_after is not None and r + 1 >= stop_after:
                break
        if prof is not None:
            # gauges, not log entries: profiling output rides the metrics
            # registry so signatures never move
            total = perf_counter() - _r0  # analysis: allow[DET001]
            events = len(self.log.entries) - _ev0
            g = self.metrics.gauge
            g("sim_events_per_second").set(
                round(events / total, 1) if total > 0 else 0.0)
            g("sim_profile_total_seconds").set(round(total, 6))
            for phase in sorted(prof):
                g(f"sim_profile_{phase}_seconds").set(round(prof[phase], 6))
        return self.log

    # -- checkpoint / resume --------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full simulation state into directory ``path``:
        ``trainer.msgpack`` (the trainer's arrays via
        ``repro_torch.checkpoint``) and ``engine.json`` (everything else:
        generator states carry >64-bit integers, which JSON holds and
        msgpack does not). Both writes are crash-safe (temp file + atomic
        replace), and the JSON is written last, so a directory holding
        ``engine.json`` is always a complete, loadable snapshot."""
        import json
        import os
        import tempfile

        from repro_torch.checkpoint import save_pytree

        os.makedirs(path, exist_ok=True)
        save_pytree(os.path.join(path, "trainer.msgpack"),
                    self.trainer.state_arrays())
        meta = {
            "round_next": self._round_next,
            "now": self.now,
            "acc_points": [[t, a] for t, a in self.acc_points],
            "queue_seq": self.queue._seq,
            "log": {"entries": self.log.entries, "ord": self.log._ord},
            # children list ORDER is saved verbatim: it drives post_order,
            # hence work-item order, hence the event signature
            "tree": {
                "root": self.tree.root,
                "parent": dict(self.tree.parent),
                "children": {k: list(v)
                             for k, v in self.tree.children.items()},
                "devices": sorted(self.tree.devices),
            },
            "churn": {
                "rng": self.churn.rng.bit_generator.state,
                "offline_until": self.churn.offline_map(),
                "stragglers": self.churn.stragglers_sorted,
            },
            "faults": self.faults.state() if self.faults is not None
            else None,
            "comm": {
                "bytes": dict(self.trainer.comm.bytes),
                "events": dict(self.trainer.comm.events),
            },
            "trainer": self.trainer.state_meta(),
        }
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(path, "engine.json"))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.metrics.counter("sim_checkpoints_total").inc()

    def restore_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` snapshot (the port's or the
        reference's) into THIS engine, constructed with the same trainer,
        scenario and seed. Every stream a round consumes is restored —
        churn and fault generator states, the queue's seq counter, the log
        (entries and ord), topology with children-list order, comm totals,
        and the trainer's params / optimizer states / rng — so the
        continued run is bit-identical to one that never stopped."""
        import json
        import os

        from repro_torch.checkpoint import load_pytree

        with open(os.path.join(path, "engine.json")) as f:
            meta = json.load(f)
        arrays = load_pytree(os.path.join(path, "trainer.msgpack"))

        self._round_next = int(meta["round_next"])
        self.now = float(meta["now"])
        self.acc_points = [(float(t), float(a))
                           for t, a in meta["acc_points"]]
        self.queue._seq = int(meta["queue_seq"])
        self.log.entries = list(meta["log"]["entries"])
        self.log._ord = int(meta["log"]["ord"])

        t = meta["tree"]
        self.tree.parent.clear()
        self.tree.parent.update({str(k): str(v)
                                 for k, v in t["parent"].items()})
        self.tree.children.clear()
        self.tree.children.update({str(k): [str(c) for c in v]
                                   for k, v in t["children"].items()})
        self._lk_cache.clear()  # link tiers of the restored topology

        self.churn.rng.bit_generator.state = meta["churn"]["rng"]
        self.churn.load_offline(meta["churn"]["offline_until"])
        self.churn.stragglers = set(meta["churn"]["stragglers"])

        if self.faults is not None and meta["faults"] is not None:
            self.faults.load_state(meta["faults"])

        comm = self.trainer.comm
        comm.bytes.clear()
        comm.bytes.update({str(k): float(v)
                           for k, v in meta["comm"]["bytes"].items()})
        comm.events.clear()
        comm.events.update({str(k): int(v)
                            for k, v in meta["comm"]["events"].items()})

        self.trainer.load_state(meta["trainer"], arrays)

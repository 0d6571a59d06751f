"""The port's determinism and layering rules.

Counterpart of ``repro.analysis.rules``: every rule ID of the reference,
so annotations and ``--explain`` carry over, each scoped to
``src/repro_torch/``. Every rule has a stable ID (the ``DET`` / ``PERF`` /
``ARCH`` / ``OBS`` families), a path scope and an ``explain`` text, which
``python -m repro_torch.analysis --explain RULE`` prints. The invariants
they guard are the ones the port's tests hold against the reference:

* the event signatures (``benchmarks/tables/scenarios.json``, held bit for
  bit by ``tests/test_torch_sim_engine.py``) are a pure function of
  (scenario, seed): no wall clock, no unseeded randomness (numpy's, the
  stdlib's or torch's global generator), no hash-ordered iteration near
  event emission;
* the kernel library is loaded, and its kernels launched and counted, in
  one place (``kernels/_lib.py``), and process groups and device meshes
  are made in one place (``launch/mesh.py``);
* algorithm dispatch is registry-only: no duck-typed probing of the
  ``FLAlgorithm`` surface outside ``fl/api.py``;
* tracing off costs one ``None`` test: every tracer call sits behind it.

Suppress a deliberate exception inline with ``# analysis: allow[ID]`` on
the offending line (or the line above), or grandfather it in
``analysis-baseline-torch.json``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.visitor import FileContext, canonical, receiver_src

PKG = "src/repro_torch/"
RULES: dict[str, "Rule"] = {}


def register_rule(cls):
    rule = cls()
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    RULES[rule.id] = rule
    return cls


def default_rules() -> list["Rule"]:
    return [RULES[k] for k in sorted(RULES)]


class Rule:
    id: str = ""
    title: str = ""
    explain: str = ""
    #: path prefixes the rule applies to (repo-relative, "/"-separated)
    scope: tuple[str, ...] = (PKG,)
    #: path prefixes or files exempt even inside the scope
    exempt: tuple[str, ...] = ()

    def applies_to(self, path: str) -> bool:
        if not any(path.startswith(p) for p in self.scope):
            return False
        return not any(path.startswith(p) for p in self.exempt)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, msg: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 0), msg)


def _calls(ctx: FileContext) -> Iterator[ast.Call]:
    return (n for n in ast.walk(ctx.tree) if isinstance(n, ast.Call))


def _iterables(ctx: FileContext) -> list[ast.AST]:
    """The iterables of every for loop and comprehension in the file."""
    iters: list[ast.AST] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.For):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            iters.extend(gen.iter for gen in node.generators)
    return iters


# ---------------------------------------------------------------------------
# DET: determinism (the scenarios.json signature contract)
# ---------------------------------------------------------------------------

#: files whose control flow feeds event emission or signatures
_SIGNATURE_SCOPE = (PKG + "sim/", PKG + "fl/", PKG + "core/")


@register_rule
class Det001WallClock(Rule):
    id = "DET001"
    title = "no wall-clock reads in signature-bearing code"
    scope = _SIGNATURE_SCOPE
    explain = (
        "Simulated time is the only clock the scheduler may read: the port's\n"
        "event signatures are held bit for bit to the reference's\n"
        "(benchmarks/tables/scenarios.json, tests/test_torch_sim_engine.py),\n"
        "so they must be a pure function of (scenario, seed). A time.time(),\n"
        "perf_counter() or datetime.now() read that reaches scheduling or an\n"
        "event payload makes replays diverge. Host-side measurement that stays\n"
        "out of the event log (RunResult.wall_s and round_s, a profiler's\n"
        "wall times, metrics histograms) is legitimate: annotate those sites\n"
        "with `# analysis: allow[DET001]`."
    )

    _CLOCKS = {
        "time.time", "time.time_ns", "time.perf_counter",
        "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
        "time.process_time", "time.process_time_ns",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today", "datetime.date.today",
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _calls(ctx):
            name = canonical(ctx, node.func)
            if name in self._CLOCKS:
                yield self.finding(
                    ctx, node,
                    f"wall-clock read `{name}` in signature-bearing code; use "
                    "simulated time, or annotate a host-only measurement with "
                    "`# analysis: allow[DET001]`")


def _has_generator(call: ast.Call) -> bool:
    """Whether the call passes ``generator=`` (or a ``**`` splat that may)."""
    return any(k.arg in ("generator", None) for k in call.keywords)


@register_rule
class Det002UnseededRandom(Rule):
    id = "DET002"
    title = "no unseeded randomness"
    scope = (PKG,)
    explain = (
        "All randomness flows from an explicit seed: numpy through\n"
        "np.random.default_rng(seed) Generators, torch through a\n"
        "torch.Generator seeded by the caller and passed as `generator=`.\n"
        "numpy's module-level sampling (np.random.normal, np.random.seed, ...),\n"
        "the stdlib `random` module and torch's global generator\n"
        "(torch.manual_seed, torch.cuda.manual_seed_all, and torch.rand /\n"
        "randn / randint / randperm / normal / bernoulli / multinomial or a\n"
        "Tensor's normal_ / uniform_ / bernoulli_ / random_ / exponential_\n"
        "with no `generator=`) draw from process-global state that any import\n"
        "or earlier draw perturbs, so two runs of one (scenario, seed) stop\n"
        "being bit-identical and the port stops matching the reference's\n"
        "draws. A bare default_rng() is OS entropy: equally forbidden."
    )

    _NP_ALLOWED = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                   "PCG64", "Philox"}
    _TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                    "torch.random.seed", "torch.cuda.manual_seed",
                    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all"}
    _TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
                    "torch.normal", "torch.bernoulli", "torch.multinomial"}
    _TENSOR_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_", "exponential_"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _calls(ctx):
            name = canonical(ctx, node.func)
            if name is None:
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in self._TENSOR_DRAWS and not _has_generator(node)):
                    yield self.finding(
                        ctx, node,
                        f"`.{node.func.attr}(...)` with no `generator=` draws from "
                        "torch's global generator; pass a seeded torch.Generator")
                continue
            if name == "random" or name.startswith("random."):
                yield self.finding(
                    ctx, node,
                    f"stdlib `{name}` draws from process-global RNG state; use "
                    "np.random.default_rng(seed) or a seeded torch.Generator")
            elif name.startswith("numpy.random."):
                leaf = name.rsplit(".", 1)[1]
                if leaf == "default_rng":
                    if not node.args and not node.keywords:
                        yield self.finding(
                            ctx, node,
                            "`default_rng()` without a seed draws OS entropy; pass "
                            "an explicit seed")
                elif leaf not in self._NP_ALLOWED:
                    yield self.finding(
                        ctx, node,
                        f"module-level `{name}` uses numpy's global RNG; use a "
                        "seeded np.random.default_rng Generator")
            elif name in self._TORCH_SEEDS:
                yield self.finding(
                    ctx, node,
                    f"`{name}` seeds torch's process-global generator; seed a "
                    "torch.Generator and pass it as `generator=`")
            elif name in self._TORCH_DRAWS and not _has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"`{name}` with no `generator=` draws from torch's global "
                    "generator; pass a seeded torch.Generator")
            elif (name.rsplit(".", 1)[-1] in self._TENSOR_DRAWS
                  and not _has_generator(node)):
                yield self.finding(
                    ctx, node,
                    f"`{name}` with no `generator=` draws from torch's global "
                    "generator; pass a seeded torch.Generator")


@register_rule
class Det003UnorderedIteration(Rule):
    id = "DET003"
    title = "no hash-ordered iteration near event emission"
    scope = _SIGNATURE_SCOPE
    explain = (
        "Python's set iteration order is salted hash order (PYTHONHASHSEED):\n"
        "a `for v in some_set` that feeds event emission or a signature\n"
        "reorders events between processes. Wrap the iterable in sorted(...),\n"
        "as the scheduler does for stragglers, offline windows and churn\n"
        "draws. dict / .keys() iteration is insertion-ordered, but the\n"
        "insertion order is rarely part of the determinism contract, so\n"
        "explicit .keys() loops are flagged too; iterate sorted(d) instead."
    )

    def _offending_iter(self, ctx: FileContext, it: ast.AST) -> str | None:
        if isinstance(it, (ast.Set, ast.SetComp)):
            return "a set literal/comprehension"
        if isinstance(it, ast.Call):
            if isinstance(it.func, ast.Name) and it.func.id in ("set", "frozenset"):
                return f"a {it.func.id}() result"
            if canonical(ctx, it.func) in ("builtins.set", "builtins.frozenset"):
                return "a set() result"
            if isinstance(it.func, ast.Attribute) and it.func.attr == "keys":
                return "dict.keys()"
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for it in _iterables(ctx):
            what = self._offending_iter(ctx, it)
            if what is not None:
                yield self.finding(
                    ctx, it,
                    f"iteration over {what} is hash/insertion-ordered; wrap in "
                    "sorted(...) so event order is deterministic")


@register_rule
class Det004FaultStreamConstruction(Rule):
    id = "DET004"
    title = "simulator RNGs are constructed once, in __init__"
    scope = (PKG + "sim/",)
    explain = (
        "Fault, churn and network randomness comes from streams a process\n"
        "object owns and builds once, in its __init__ (FaultProcess: one\n"
        "SeedSequence-derived Generator per concern). Building a Generator\n"
        "inside a draw path (default_rng(...), SeedSequence(...),\n"
        "PCG64 / Philox(...), torch.Generator(...) in loss_prob, draw_round,\n"
        "plan_attempts, at module level, ...) re-keys the stream per call, so\n"
        "the schedule of fault events stops being a pure function of\n"
        "(scenario, seed, plan), and checkpoint-resume (which snapshots the\n"
        "streams' bit-generator state) can no longer replay it. Pre-run\n"
        "one-shot derivations (byzantine label noise, applied before the\n"
        "engine exists) are the deliberate exception: annotate them with\n"
        "`# analysis: allow[DET004]`."
    )

    _CTORS = {
        "numpy.random.default_rng", "numpy.random.Generator",
        "numpy.random.SeedSequence", "numpy.random.PCG64",
        "numpy.random.Philox", "torch.Generator",
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _calls(ctx):
            name = canonical(ctx, node.func)
            if name not in self._CTORS:
                continue
            fn = ctx.enclosing_function(node)
            if fn is not None and fn.name == "__init__":
                continue
            where = f"in `{fn.name}`" if fn is not None else "at module level"
            yield self.finding(
                ctx, node,
                f"`{name}` constructed {where}; simulator RNG streams are built "
                "once in __init__ so fault schedules replay bit-identically "
                "(checkpoint-resume snapshots their state)")


# ---------------------------------------------------------------------------
# PERF: population-scale scheduler hot paths
# ---------------------------------------------------------------------------


@register_rule
class Perf001PerNodeLoop(Rule):
    id = "PERF001"
    title = "no per-node Python loops over the population in sim hot paths"
    scope = (PKG + "sim/",)
    explain = (
        "The simulator's core is array-resident, as the reference's: churn,\n"
        "offline windows and rejoin sweeps are numpy operations over the\n"
        "whole population, because a Python `for v in tree.devices` that runs\n"
        "every round costs O(population) interpreter steps. Loops (or\n"
        "comprehensions) over `*.devices` / `*.nodes` are allowed only in\n"
        "construction paths (`__init__`), which run once. A hot-path site\n"
        "that is scalar on purpose (a draw loop kept in the reference's RNG\n"
        "consumption order, so the signatures match) says so with\n"
        "`# analysis: allow[PERF001]`."
    )

    _POPULATION_ATTRS = frozenset({"devices", "nodes"})
    #: wrappers that do not change what is iterated
    _TRANSPARENT = frozenset({"sorted", "list", "tuple", "enumerate", "reversed", "set",
                              "frozenset"})

    def _population_src(self, node: ast.AST) -> str | None:
        """The source of a population-sized iterable, through transparent
        wrappers (``sorted(tree.devices)`` still walks the population)."""
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Name) and node.func.id in self._TRANSPARENT
                    and node.args):
                return self._population_src(node.args[0])
            return None
        if isinstance(node, ast.Attribute) and node.attr in self._POPULATION_ATTRS:
            return receiver_src(node) or node.attr
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for it in _iterables(ctx):
            src = self._population_src(it)
            if src is None:
                continue
            fn = ctx.enclosing_function(it)
            if fn is not None and fn.name == "__init__":
                continue  # construction: runs once, not per round
            yield self.finding(
                ctx, it,
                f"per-node Python loop over `{src}` outside __init__; hot paths "
                "sweep the population with array ops, or annotate a deliberate "
                "scalar path with `# analysis: allow[PERF001]`")


# ---------------------------------------------------------------------------
# ARCH: layering (shim routing + registry-only dispatch)
# ---------------------------------------------------------------------------

#: a query entry of the kernel library (an instance's attributes, a
#: shared-memory need): it launches nothing, so it may be called directly
_QUERY_SUFFIXES = ("_attrs", "_smem")


@register_rule
class Arch001ShimRouting(Rule):
    id = "ARCH001"
    title = "raw low-level APIs only inside their shims"
    scope = (PKG,)
    explain = (
        "The port keeps its low-level APIs in two shims, as the reference\n"
        "keeps Pallas and make_mesh in pallas_compat and launch.mesh:\n"
        "- repro_torch.kernels._lib loads the kernel library (ctypes.CDLL),\n"
        "  binds each entry's argument types (_SIGNATURES) and launches a\n"
        "  kernel through _lib.launch, which counts the launch and takes the\n"
        "  meta path on `meta` tensors. An entry of _lib.lib() called\n"
        "  anywhere else skips the count (chip_smoke.py's proof that the main\n"
        "  path ran the kernel) and the dry run's meta trace; only the query\n"
        "  entries (*_attrs, *_smem), which launch nothing, may be.\n"
        "- repro_torch.launch.mesh makes the process group and the device\n"
        "  meshes (dist.init_process_group, DeviceMesh, init_device_mesh), so\n"
        "  that every mesh has the reference's axis names and the card's\n"
        "  backend."
    )

    _LIB = "repro_torch.kernels._lib.lib"
    _LIB_OK = (PKG + "kernels/_lib.py",)
    _CDLL = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary"}
    _MESH_OK = (PKG + "launch/mesh.py",)

    @staticmethod
    def _mesh_api(name: str) -> bool:
        if not name.startswith("torch.distributed"):
            return False
        leaf = name.rsplit(".", 1)[-1]
        return leaf in ("init_process_group", "DeviceMesh", "init_device_mesh")

    def _lib_use(self, ctx: FileContext, call: ast.Call) -> str | None:
        """The entry a ``_lib.lib()`` call's result is used for, if that use
        is a query entry; else the spelling of the use."""
        parent = ctx.parents.get(call)
        if isinstance(parent, ast.Attribute):
            return None if parent.attr.endswith(_QUERY_SUFFIXES) else f"`lib().{parent.attr}`"
        if (isinstance(parent, ast.Call) and isinstance(parent.func, ast.Name)
                and parent.func.id == "getattr" and parent.args and parent.args[0] is call
                and len(parent.args) >= 2):
            name = parent.args[1]
            if isinstance(name, ast.Constant) and str(name.value).endswith(_QUERY_SUFFIXES):
                return None
            return f"`getattr(lib(), {receiver_src(name)})`"
        return "a `lib()` handle kept past the call"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _calls(ctx):
            name = canonical(ctx, node.func)
            if name is None:
                continue
            if name in self._CDLL and not ctx.path.startswith(self._LIB_OK):
                yield self.finding(
                    ctx, node,
                    f"`{name}` outside repro_torch.kernels._lib; the kernel library "
                    "is loaded and its argument types bound there")
            elif name == self._LIB and not ctx.path.startswith(self._LIB_OK):
                use = self._lib_use(ctx, node)
                if use is not None:
                    yield self.finding(
                        ctx, node,
                        f"kernel entry reached through {use} outside _lib.py; "
                        "launch through _lib.launch (it counts the launch and takes "
                        "the meta path), or call only a query entry (*_attrs, *_smem)")
            elif self._mesh_api(name) and not ctx.path.startswith(self._MESH_OK):
                yield self.finding(
                    ctx, node,
                    f"`{name}` outside repro_torch.launch.mesh; make process groups "
                    "and meshes through make_host_mesh")


@register_rule
class Arch002DuckProbing(Rule):
    id = "ARCH002"
    title = "no duck-typed algorithm probing outside fl/api.py"
    scope = (PKG,)
    exempt = (PKG + "fl/api.py",)
    explain = (
        "Algorithm dispatch is registry-only, as in the reference: the\n"
        "FLAlgorithm base class and the @register_algorithm registry\n"
        "(repro_torch.fl.api) declare the surface the scheduler calls, and\n"
        "nothing sniffs for it. A hasattr(trainer, 'execute_batch') or an\n"
        "isinstance(x, FedEEC) outside fl/api.py brings back the\n"
        "per-algorithm special cases the work-item API removed. Extend the\n"
        "FLAlgorithm base class (with a default) instead of probing."
    )

    #: the FLAlgorithm surface a probe would sniff for
    _API_ATTRS = frozenset({
        "work_items", "execute", "execute_batch", "batch_signature",
        "begin_round", "end_round", "set_participation", "participates",
        "train_round", "migrate", "try_migrate", "on_migrate_refused",
        "cloud_params", "cloud_apply", "on_item_failed",
        "state_arrays", "state_meta", "load_state",
    })
    _ALGO_TYPES = frozenset({"FLAlgorithm", "FedEEC", "HierarchicalFedAvg", "FlatFedAvg"})

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _calls(ctx):
            if not isinstance(node.func, ast.Name) or len(node.args) != 2:
                continue
            if node.func.id == "hasattr":
                attr = node.args[1]
                if isinstance(attr, ast.Constant) and attr.value in self._API_ATTRS:
                    yield self.finding(
                        ctx, node,
                        f"hasattr probe for FLAlgorithm API {attr.value!r}; dispatch "
                        "through the registry / base-class default instead")
            elif node.func.id == "isinstance":
                types = node.args[1]
                names = list(types.elts) if isinstance(types, ast.Tuple) else [types]
                for t in names:
                    leaf = (t.attr if isinstance(t, ast.Attribute)
                            else t.id if isinstance(t, ast.Name) else None)
                    if leaf in self._ALGO_TYPES:
                        yield self.finding(
                            ctx, node,
                            f"isinstance check against algorithm type {leaf!r}; "
                            "algorithms are dispatched via the FLAlgorithm surface, "
                            "not their concrete class")
                        break


# ---------------------------------------------------------------------------
# OBS: telemetry inertness
# ---------------------------------------------------------------------------


@register_rule
class Obs001UnguardedTracer(Rule):
    id = "OBS001"
    title = "tracer call sites must sit behind the None guard"
    scope = (PKG,)
    exempt = (PKG + "obs/",)
    explain = (
        "Tracing off must cost one global read: every call to a tracer's\n"
        ".span() / .add_span() / .instant() outside repro_torch.obs is\n"
        "reachable only when the tracer is known to be non-None: an enclosing\n"
        "`if tr is not None:` block, the\n"
        "`tr.span(...) if tr is not None else nullcontext()` with-item idiom,\n"
        "or an early `if tr is None: return ...` in the same function. An\n"
        "unguarded site either crashes with tracing off or forces a tracer\n"
        "into a hot path (and a traced run's log must equal the untraced\n"
        "one's, tests/test_torch_obs.py)."
    )

    _METHODS = frozenset({"span", "add_span", "instant"})

    @staticmethod
    def _is_tracer_recv(recv: str) -> bool:
        return recv in ("tr", "tracer") or recv.endswith(".tracer")

    @staticmethod
    def _none_test(test: ast.AST, recv: str) -> str | None:
        """'is_none' / 'is_not_none' when ``test`` (or a conjunct of an
        `and`) compares ``recv`` with None."""
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            for sub in test.values:
                got = Obs001UnguardedTracer._none_test(sub, recv)
                if got:
                    return got
            return None
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            return None
        if not (isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None):
            return None
        if receiver_src(test.left) != recv:
            return None
        if isinstance(test.ops[0], ast.Is):
            return "is_none"
        if isinstance(test.ops[0], ast.IsNot):
            return "is_not_none"
        return None

    def _guarded(self, ctx: FileContext, call: ast.Call, recv: str) -> bool:
        # an enclosing If / IfExp with the right branch
        for parent, child in ctx.parent_chain(call):
            if isinstance(parent, ast.IfExp):
                kind = self._none_test(parent.test, recv)
                if (kind == "is_not_none" and child is parent.body) or \
                        (kind == "is_none" and child is parent.orelse):
                    return True
            elif isinstance(parent, ast.If):
                kind = self._none_test(parent.test, recv)
                if (kind == "is_not_none" and child in parent.body) or \
                        (kind == "is_none" and child in parent.orelse):
                    return True
        # an early exit earlier in the same function: if recv is None: return
        fn = ctx.enclosing_function(call)
        if fn is not None:
            for node in ast.walk(fn):
                if (isinstance(node, ast.If) and node.lineno < call.lineno
                        and self._none_test(node.test, recv) == "is_none"
                        and node.body
                        and isinstance(node.body[-1], (ast.Return, ast.Raise, ast.Continue))):
                    return True
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in _calls(ctx):
            if not (isinstance(node.func, ast.Attribute) and node.func.attr in self._METHODS):
                continue
            recv = receiver_src(node.func.value)
            if self._is_tracer_recv(recv) and not self._guarded(ctx, node, recv):
                yield self.finding(
                    ctx, node,
                    f"`{recv}.{node.func.attr}(...)` is not guarded by a "
                    f"`{recv} is not None` check; tracing off must stay one None test")

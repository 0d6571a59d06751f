"""The AST scanning framework the rules run in.

Counterpart of ``repro.analysis.visitor``. One :class:`FileContext` per
scanned file carries what a rule needs to judge a node without reading the
source again: the parsed tree, a child -> parent map (``ast`` has no
links upward), the import alias table, and the per-line ``# analysis:
allow[...]`` suppressions.

Name resolution (:func:`canonical`) substitutes import aliases, so a rule
matches what a name refers to, not how the file spells it::

    import numpy as np              np.random.normal -> numpy.random.normal
    from time import perf_counter   perf_counter     -> time.perf_counter
    import torch.distributed as dist
                                    dist.init_process_group
                                        -> torch.distributed.init_process_group

A base that is no imported name (a local, an attribute of ``self``, a call
result) resolves to ``None``; rules that judge a receiver's spelling
(OBS001) read ``ast.unparse`` instead.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from repro_torch.analysis.findings import Finding, is_allowed, parse_allows


@dataclass
class FileContext:
    path: str  # repo-relative, forward slashes
    source: str
    tree: ast.Module
    parents: dict[ast.AST, ast.AST] = field(default_factory=dict)
    aliases: dict[str, str] = field(default_factory=dict)
    allows: dict[int, set[str]] = field(default_factory=dict)

    def parent_chain(self, node: ast.AST):
        """Yield (parent, child) pairs from ``node`` up to the module."""
        child = node
        while child in self.parents:
            parent = self.parents[child]
            yield parent, child
            child = parent

    def enclosing_function(self, node: ast.AST):
        for parent, _ in self.parent_chain(node):
            if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return parent
        return None


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name != "*":
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def build_context(path: str, source: str) -> FileContext:
    tree = ast.parse(source, filename=path)
    ctx = FileContext(path=path.replace(os.sep, "/"), source=source, tree=tree,
                      aliases=_collect_aliases(tree), allows=parse_allows(source))
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            ctx.parents[child] = parent
    return ctx


def canonical(ctx: FileContext, node: ast.AST) -> str | None:
    """The import-resolved dotted name of ``node``, or None if its base is
    no imported name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = ctx.aliases.get(node.id)
    if base is None:
        return None
    parts.append(base)
    return ".".join(reversed(parts))


def receiver_src(node: ast.AST) -> str:
    """The source spelling of a call's receiver (``ast.unparse``)."""
    try:
        return ast.unparse(node)
    except Exception:
        return ""


def scan_source(source: str, path: str, rules) -> tuple[list[Finding], list[Finding]]:
    """Run the ``rules`` whose scope holds ``path`` over ``source``.

    Returns ``(findings, suppressed)``: a suppressed finding matched an
    inline ``# analysis: allow[RULE]``. ``path`` is the repo-relative path
    the rules' scopes read, so tests scan a fixture under a virtual
    ``src/repro_torch/...`` path.
    """
    ctx = build_context(path, source)
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for rule in rules:
        if not rule.applies_to(ctx.path):
            continue
        for f in rule.check(ctx):
            (suppressed if is_allowed(f, ctx.allows) else findings).append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed


def scan_tree(root: str, rel_paths: list[str], rules) -> tuple[list[Finding], list[Finding]]:
    """Scan every ``.py`` file under the ``root``-relative ``rel_paths``, in
    a sorted walk."""
    files: list[str] = []
    for rel in rel_paths:
        top = os.path.join(root, rel)
        if os.path.isfile(top):
            files.append(top)
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames.sort()
            files.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                         if fn.endswith(".py"))
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for abspath in files:
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        with open(abspath, encoding="utf-8") as f:
            source = f.read()
        try:
            got, supp = scan_source(source, rel, rules)
        except SyntaxError as e:
            findings.append(Finding("SYNTAX", rel, e.lineno or 0, str(e.msg)))
            continue
        findings.extend(got)
        suppressed.extend(supp)
    return findings, suppressed

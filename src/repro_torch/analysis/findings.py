"""The finding stream and baseline file that both analysis engines share.

Counterpart of ``repro.analysis.findings``. A :class:`Finding` is one rule
violation (an AST rule or a kernel contract) pinned to a repo-relative
path and line. Findings are grandfathered by a checked-in JSON baseline,
``analysis-baseline-torch.json`` at the repository root (the port's own;
the JAX package keeps ``analysis-baseline.json``): a finding whose
:meth:`Finding.key` is in the baseline is reported as grandfathered
instead of failing the run. The accepted state is an empty baseline.

Inline suppression uses the reference's annotation comment

    some_call()  # analysis: allow[DET001]

on the offending line or the line directly above it (several IDs are
comma-separated). :func:`parse_allows` reads the per-line allow sets from
the raw source, so the AST visitors never scan text again.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\[([A-Z0-9_,\s]+)\]")


@dataclass(frozen=True)
class Finding:
    """One violation: ``rule`` is the stable ID (e.g. ``DET001``)."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    engine: str = "ast"  # "ast" | "kernel"

    def key(self) -> str:
        """The baseline key. It leaves out the message, so rewording a
        diagnostic keeps a grandfathered entry."""
        return f"{self.rule}:{self.path}:{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "engine": self.engine,
        }


def parse_allows(source: str) -> dict[int, set[str]]:
    """Line number (1-based) -> the rule IDs allowed on that line."""
    allows: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            allows[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return allows


def is_allowed(finding: Finding, allows: dict[int, set[str]]) -> bool:
    """An annotation suppresses a finding on its own line or on the line
    below it (the comment sits above the offending call)."""
    return any(finding.rule in allows.get(line, set())
               for line in (finding.line, finding.line - 1))


BASELINE_NAME = "analysis-baseline-torch.json"


@dataclass
class Baseline:
    keys: set[str] = field(default_factory=set)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            payload = json.load(f)
        return cls(set(payload.get("findings", [])))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"findings": sorted(self.keys)}, f, indent=1)
            f.write("\n")

    def split(self, findings: list[Finding]) -> tuple[list[Finding], list[Finding]]:
        """(new, grandfathered) partition of ``findings``."""
        new = [f for f in findings if f.key() not in self.keys]
        old = [f for f in findings if f.key() in self.keys]
        return new, old

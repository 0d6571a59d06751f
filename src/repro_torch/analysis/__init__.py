"""The port's static analysis: the invariant linter and the Hopper kernels'
contract analyzer.

Counterpart of ``repro.analysis``. Two engines feed one
:class:`~repro_torch.analysis.findings.Finding` stream:

* the AST rules (:mod:`repro_torch.analysis.rules`,
  :mod:`repro_torch.analysis.visitor`) guard determinism and layering over
  ``src/repro_torch/``: rule IDs ``DET001``-``DET004``, ``PERF001``,
  ``ARCH001``-``ARCH002`` and ``OBS001``, the reference's;
* the kernel contract analyzer (:mod:`repro_torch.analysis.kernel_contracts`)
  checks the CUDA kernels' contracts from their sources and a trace on the
  ``meta`` device: rule IDs ``KRN001``-``KRN005``.

It reads source and takes no card. Entry point: ``python -m
repro_torch.analysis`` (``--help``), against the port's own baseline,
``analysis-baseline-torch.json``, which is kept empty.
"""
from repro_torch.analysis.findings import BASELINE_NAME, Baseline, Finding
from repro_torch.analysis.kernel_contracts import (
    CONTRACTS,
    DEFAULT_SMEM_LIMIT,
    check_all,
    contract_table,
)
from repro_torch.analysis.rules import RULES, default_rules
from repro_torch.analysis.visitor import scan_source, scan_tree

__all__ = ["BASELINE_NAME", "Baseline", "CONTRACTS", "DEFAULT_PATHS", "DEFAULT_SMEM_LIMIT",
           "Finding", "RULES", "check_all", "contract_table", "default_rules", "repo_root",
           "run_analysis", "scan_source", "scan_tree"]

#: repo-relative paths the AST engine scans by default
DEFAULT_PATHS = ("src/repro_torch",)


def repo_root() -> str:
    """The repository's root, found from this package's place in src/."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run_analysis(root: str | None = None, paths: tuple[str, ...] = DEFAULT_PATHS,
                 kernels: bool = True, smem_limit: int = DEFAULT_SMEM_LIMIT):
    """Run both engines; returns ``(findings, suppressed)`` before the
    baseline, the findings in a deterministic order. The caller applies the
    baseline's split (the CLI and ``chip_smoke.py`` do)."""
    root = repo_root() if root is None else root
    findings, suppressed = scan_tree(root, list(paths), default_rules())
    if kernels:
        findings = findings + check_all(smem_limit)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed

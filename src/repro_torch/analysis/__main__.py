"""The port's static analysis from the command line.

    python -m repro_torch.analysis                  # rules + kernel contracts; exit 1 on new findings
    python -m repro_torch.analysis --explain DET001
    python -m repro_torch.analysis --json           # the finding stream as JSON
    python -m repro_torch.analysis --write-baseline # grandfather the current findings

Counterpart of ``python -m repro.analysis``, with its flags; its VMEM budget
becomes a shared-memory limit a block (``--smem-limit``, sm_90's opt-in
limit by default). Exit code 0 means every finding is inline-allowed or
grandfathered in the baseline (``analysis-baseline-torch.json`` at the
repository root, kept empty). It reads source and takes no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import (
    BASELINE_NAME,
    DEFAULT_PATHS,
    DEFAULT_SMEM_LIMIT,
    Baseline,
    repo_root,
    run_analysis,
)
from repro_torch.analysis.kernel_contracts import KRN_EXPLAIN
from repro_torch.analysis.rules import RULES


def explain(rule_id: str) -> int:
    rule_id = rule_id.upper()
    if rule_id in RULES:
        rule = RULES[rule_id]
        print(f"{rule.id}: {rule.title}")
        print(f"  scope: {', '.join(rule.scope)}"
              + (f"  (exempt: {', '.join(rule.exempt)})" if rule.exempt else ""))
        print()
        for ln in rule.explain.splitlines():
            print(f"  {ln}")
        return 0
    if rule_id in KRN_EXPLAIN:
        print(f"{rule_id}: {KRN_EXPLAIN[rule_id]}")
        print("  engine: kernel contracts (src/repro_torch/analysis/kernel_contracts.py)")
        return 0
    known = sorted(RULES) + sorted(KRN_EXPLAIN)
    print(f"unknown rule {rule_id!r}; known rules: {', '.join(known)}", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's invariant linter and Hopper kernel contract analyzer")
    ap.add_argument("--explain", metavar="RULE", help="print what a rule ID guards and exit")
    ap.add_argument("--json", action="store_true", help="emit the finding stream as JSON")
    ap.add_argument("--paths", nargs="+", default=list(DEFAULT_PATHS),
                    help="repo-relative paths to scan (default: src/repro_torch)")
    ap.add_argument("--root", default=None,
                    help="repository root (default: found from the package)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{BASELINE_NAME})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather all current findings into the baseline")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel contract engine (AST rules only)")
    ap.add_argument("--smem-limit", type=int, default=DEFAULT_SMEM_LIMIT,
                    help="shared memory a block may have, in bytes (default: "
                         f"{DEFAULT_SMEM_LIMIT}, sm_90's opt-in limit)")
    args = ap.parse_args(argv)

    if args.explain:
        return explain(args.explain)

    root = os.path.abspath(args.root) if args.root else repo_root()
    findings, suppressed = run_analysis(root=root, paths=tuple(args.paths),
                                        kernels=not args.no_kernels,
                                        smem_limit=args.smem_limit)

    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)
    if args.write_baseline:
        bl = Baseline({f.key() for f in findings})
        bl.save(baseline_path)
        print(f"wrote {len(bl.keys)} grandfathered finding(s) to {baseline_path}")
        return 0

    new, grandfathered = Baseline.load(baseline_path).split(findings)

    if args.json:
        print(json.dumps({
            "new": [f.to_json() for f in new],
            "grandfathered": [f.to_json() for f in grandfathered],
            "suppressed": [f.to_json() for f in suppressed],
        }, indent=1))
        return 1 if new else 0

    for f in new:
        print(f.render())
    tail = (f"{len(new)} finding(s), {len(grandfathered)} grandfathered, "
            f"{len(suppressed)} inline-allowed")
    if new:
        print(f"FAIL: {tail}", file=sys.stderr)
        print(f"  (explain a rule: python -m repro_torch.analysis --explain {new[0].rule})",
              file=sys.stderr)
        return 1
    print(f"OK: {tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Critical-path report CLI, counterpart of ``repro.obs.report``.

    python -m repro_torch.obs.report RUN.json [--round N] [--json]

``RUN.json`` is either a Chrome trace written by ``runner.py --trace``
(detected by its ``traceEvents`` key; exact compute/transfer attribution)
or a raw event log written by ``runner.py --out`` (straggler attribution
from the log's ``straggle`` notes). Prints the per-round gating report;
``--json`` emits the reconstruction machine-readably instead. It reads
the reference's files as well as the port's.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.critical_path import (
    explain,
    rounds_from_eventlog,
    rounds_from_trace,
)


def load_reports(path: str):
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict) and "traceEvents" in payload:
        return rounds_from_trace(payload), "trace"
    if isinstance(payload, list):
        return rounds_from_eventlog(payload), "eventlog"
    raise ValueError(
        f"{path}: neither a Chrome trace (dict with 'traceEvents') nor an "
        "event log (list of entries)"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Per-round critical-path attribution from a trace or "
                    "event log",
    )
    ap.add_argument("path", help="trace JSON (--trace) or event log (--out)")
    ap.add_argument("--round", type=int, default=None,
                    help="report a single round")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable reconstruction")
    args = ap.parse_args(argv)

    try:
        reports, source = load_reports(args.path)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.round is not None:
        reports = [r for r in reports if r.round == args.round]
        if not reports:
            print(f"error: no round {args.round} in {args.path}",
                  file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps([
            {
                "round": r.round,
                "makespan_s": round(r.makespan, 6),
                "items": len(r.items),
                "idle": r.idle,
                "gate_node": r.gate_node,
                "gate_factor": r.gate_factor,
                "gate_share": (round(r.gate.dur / max(r.makespan, 1e-12), 4)
                               if r.gate else 0.0),
                "path": [
                    {"kind": it.kind, "node": it.node, "peer": it.peer,
                     "start": round(it.start, 6), "dur": round(it.dur, 6)}
                    for it in r.path
                ],
                "slack_s": [round(s, 6) for s in r.slack],
            }
            for r in reports
        ], indent=1))
    else:
        print(f"source: {source} ({args.path})")
        print(explain(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())

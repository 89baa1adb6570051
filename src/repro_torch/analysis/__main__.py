"""CLI: ``python -m repro_torch.analysis [--format=text|json|github] ...``.

Exit status is 0 when clean, 1 when any finding survives exemptions —
suitable for CI gating. ``--write-manifest`` regenerates the
wire-format freeze and exits 0.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Optional, Sequence, Set

from repro_torch.analysis.findings import render
from repro_torch.analysis.runner import CHECKS, run_checks
from repro_torch.analysis.wire import write_manifest


def _default_root() -> str:
    # .../<root>/src/repro_torch/analysis/__main__.py -> <root>
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _changed_files(root: str) -> Optional[Set[str]]:
    """Repo-relative .py files that differ from HEAD (worktree + staged
    + untracked). None when git is unavailable — caller falls back to a
    full run rather than silently passing."""
    rels: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "diff", "--name-only", "--cached"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            p = subprocess.run(cmd, cwd=root, capture_output=True,
                               text=True)
        except OSError:
            return None
        if p.returncode != 0:
            return None
        rels.update(ln.strip() for ln in p.stdout.splitlines()
                    if ln.strip())
    return {r for r in rels if r.endswith(".py")}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: the port's host-sync, graph-hazard and "
                    "wire-format contract checks")
    ap.add_argument("--root", default=_default_root(),
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--format", dest="fmt", default="text",
                    choices=("text", "json", "github"),
                    help="report format (github emits workflow-command "
                         "annotations)")
    ap.add_argument("--checks", default=None,
                    help=f"comma-separated subset of "
                         f"{','.join(sorted(CHECKS))}")
    ap.add_argument("--manifest", default=None,
                    help="override the wire-format manifest path")
    ap.add_argument("--write-manifest", action="store_true",
                    help="regenerate the wire-format manifest and exit")
    ap.add_argument("--changed", action="store_true",
                    help="report only findings in files that differ from "
                         "git HEAD (worktree, staged, untracked) — the "
                         "analysis still runs over the whole repo so "
                         "repo-level checks stay sound")
    args = ap.parse_args(argv)

    if args.write_manifest:
        path = write_manifest(args.root, args.manifest)
        print(f"reprolint: wrote {path}")
        return 0

    checks = args.checks.split(",") if args.checks else None
    report = run_checks(args.root, checks=checks, manifest=args.manifest)
    if args.changed:
        changed = _changed_files(args.root)
        if changed is not None:
            # keep repo-level findings (path "" — e.g. a missing ring
            # guard) regardless: they have no single owning file
            report.findings = [f for f in report.findings
                               if not f.path or f.path in changed]
    out = render(report.findings, report.suppressed, report.num_files,
                 style=args.fmt)
    if out:
        print(out)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""WIR001/WIR002: the port's wire-format freeze against a generated
manifest.

The manifest (``src/repro_torch/analysis/manifest.json``) snapshots the
port's cross-PR comparison surfaces, read from the port's own modules:

- ``policy_codes``      — ``engine.POLICY_CODES`` (sweep cells and the
  route and decide kernels encode policies by these integers)
- ``redecide_policies`` — ``engine.REDECIDE_POLICIES``
- ``scenario_names``    — ``scenarios.names()`` registry
- ``sched_families``    — ``traffic.sched.FAMILIES``
- ``checker_codes``     — this linter's finding-code catalog (codes
  appear in CI annotations and exemption comments, so they are
  advertised surface too)

It holds no CSV schemas or benchmark keys: the port has no figure runner
or benchmark file yet, and the work that adds one adds its schemas here.

Any drift fails until the manifest is regenerated **in the same diff**
(``python -m repro_torch.analysis --write-manifest``), which turns a
silent wire-format change into an explicit, reviewable file change.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.astutil import CheckContext
from repro_torch.analysis.findings import CODES, Finding

MANIFEST_REL = "src/repro_torch/analysis/manifest.json"
ENGINE_REL = "src/repro_torch/netsim/engine.py"
REGEN = "python -m repro_torch.analysis --write-manifest"


def _import_port(root: str) -> Tuple[Any, Any, Any]:
    src = os.path.join(root, "src")
    if os.path.isdir(src) and src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.netsim import engine, scenarios  # noqa: PLC0415
    from repro_torch.traffic import sched  # noqa: PLC0415
    return engine, scenarios, sched


def build_manifest(root: str) -> Dict:
    engine, scenarios, sched = _import_port(root)
    return {
        "format": 1,
        "policy_codes": dict(engine.POLICY_CODES),
        "redecide_policies": list(engine.REDECIDE_POLICIES),
        "scenario_names": list(scenarios.names()),
        "sched_families": list(sched.FAMILIES),
        "checker_codes": sorted(CODES),
    }


def write_manifest(root: str, path: Optional[str] = None) -> str:
    path = path or os.path.join(root, MANIFEST_REL)
    manifest = build_manifest(root)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def _diff_section(want: Any, got: Any) -> str:
    if isinstance(want, dict) and isinstance(got, dict):
        added = sorted(set(got) - set(want))
        removed = sorted(set(want) - set(got))
        changed = sorted(k for k in set(want) & set(got)
                         if want[k] != got[k])
        bits = []
        if added:
            bits.append(f"added {added}")
        if removed:
            bits.append(f"removed {removed}")
        if changed:
            bits.append(f"changed {changed}")
        return "; ".join(bits) or "differs"
    if isinstance(want, list) and isinstance(got, list):
        added = sorted(set(str(x) for x in got) - set(str(x) for x in want))
        removed = sorted(set(str(x) for x in want)
                         - set(str(x) for x in got))
        bits = []
        if added:
            bits.append(f"added {added}")
        if removed:
            bits.append(f"removed {removed}")
        return "; ".join(bits) or "reordered"
    return f"was {want!r}, now {got!r}"


def check_wire(ctx: CheckContext) -> List[Finding]:
    root = ctx.root
    # only meaningful on the real repo layout (fixture trees skip)
    if not os.path.exists(os.path.join(root, ENGINE_REL)):
        return []
    manifest_path = ctx.manifest_path or os.path.join(root, MANIFEST_REL)
    rel = os.path.relpath(manifest_path, root).replace(os.sep, "/")
    if not os.path.exists(manifest_path):
        return [Finding(code="WIR002", path=rel, line=0,
                        message=f"wire-format manifest not found — "
                                f"generate it with `{REGEN}`")]
    with open(manifest_path, encoding="utf-8") as f:
        frozen = json.load(f)
    current = build_manifest(root)
    findings: List[Finding] = []
    for section in sorted(set(frozen) | set(current)):
        want, got = frozen.get(section), current.get(section)
        if want != got:
            findings.append(Finding(
                code="WIR001", path=rel, line=0,
                message=f"wire format drifted in `{section}`: "
                        f"{_diff_section(want, got)} — if intentional, "
                        f"regenerate with `{REGEN}` in this same diff"))
    return findings

"""Checker registry, file discovery, and the single-shot ``run_checks``.

Default file set: every ``.py`` under ``<root>/src/repro_torch`` plus
the port's tests (``<root>/tests/test_torch_*.py``,
``<root>/tests/torch_*.py``), excluding anything under a ``fixtures``
directory (the known-bad corpus must not dirty the repo run). A root
with neither, a fixture tree, is walked whole instead.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.analysis.astutil import CheckContext, RepoIndex
from repro_torch.analysis.axes import check_axes
from repro_torch.analysis.findings import Finding, apply_exemptions
from repro_torch.analysis.invariants import check_invariants
from repro_torch.analysis.rings import check_rings
from repro_torch.analysis.syncs import check_syncs
from repro_torch.analysis.units import check_units
from repro_torch.analysis.wire import check_wire

CHECKS: Dict[str, Callable[[CheckContext], List[Finding]]] = {
    "syncs": check_syncs,
    "axes": check_axes,
    "wire": check_wire,
    "rings": check_rings,
    "units": check_units,
    "invariants": check_invariants,
}
PACKAGE_REL = os.path.join("src", "repro_torch")
TEST_GLOBS = ("test_torch_*.py", "torch_*.py")
_SKIP_DIRS = ("fixtures", "__pycache__", ".git", ".ruff_cache",
              ".mypy_cache")


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Finding]
    num_files: int

    @property
    def ok(self) -> bool:
        return not self.findings


def _walk(top: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        out.extend(os.path.join(dirpath, fn) for fn in filenames
                   if fn.endswith(".py"))
    return out


def default_files(root: str) -> List[str]:
    pkg = os.path.join(root, PACKAGE_REL)
    tests = os.path.join(root, "tests")
    if not os.path.isdir(pkg) and not os.path.isdir(tests):
        return sorted(_walk(root))
    out = _walk(pkg) if os.path.isdir(pkg) else []
    if os.path.isdir(tests):
        out.extend(os.path.join(tests, fn) for fn in os.listdir(tests)
                   if any(fnmatch.fnmatch(fn, g) for g in TEST_GLOBS))
    return sorted(out)


def run_checks(root: str, checks: Optional[Sequence[str]] = None,
               files: Optional[Sequence[str]] = None,
               manifest: Optional[str] = None) -> Report:
    root = os.path.abspath(root)
    if files is None:
        files = default_files(root)
    index = RepoIndex(root, files)
    ctx = CheckContext(root=root, index=index, manifest_path=manifest)

    names = list(checks) if checks else list(CHECKS)
    unknown = [n for n in names if n not in CHECKS]
    if unknown:
        raise ValueError(f"unknown check(s): {unknown}; "
                         f"available: {sorted(CHECKS)}")

    findings: List[Finding] = []
    for name in names:
        findings.extend(CHECKS[name](ctx))

    sources = {mod.path: mod.lines for mod in index.modules.values()}
    kept, suppressed = apply_exemptions(findings, sources)
    kept.sort(key=lambda f: (f.path, f.line, f.code))
    return Report(findings=kept, suppressed=suppressed,
                  num_files=len(index.modules))

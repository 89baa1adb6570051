"""Finding model, the frozen code catalog, exemptions, and output formats.

A finding is ``(code, path, line, message)``. Codes are wire format for
CI annotations and the fixture corpus: new checks append fresh codes,
existing codes never change meaning. The catalog keeps the reference
linter's (``repro.analysis``) framework-neutral codes with their
meanings, drops its four JAX tracing codes (the port has no tracer) and
appends the ``DEV`` family, the port's host-sync and CUDA-graph hazards.

Exemptions are per-line source comments, the same syntax the reference
linter reads, so one comment serves both::

    lo = int(x.min())  # reprolint: ignore[DEV001] once per run, at set-up

The comment may sit on the flagged line or the line directly above it
(for flagged expressions that span multiple lines, anchor the comment on
the reported line). Several codes may share one comment:
``ignore[DEV001,DEV004]``. A justification after the bracket is
expected and ignored by the parser.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, FrozenSet, Iterable, List, Sequence, Set, Tuple

# code -> one-line description (frozen; append-only)
CODES: Dict[str, str] = {
    "AXS001": "ExpSpec sweep-axis classification missing or inconsistent "
              "(AXES_STATIC / AXES_DYNAMIC / AXES_EXEMPT)",
    "AXS002": "axis declared dynamic but read by spec_to_cfg — it would "
              "recompile every sweep cell",
    "AXS003": "axis declared static but never reaches the trace key via "
              "spec_to_cfg",
    "WIR001": "wire-format drift vs manifest.json — regenerate with "
              "`python -m repro_torch.analysis --write-manifest` in this "
              "diff",
    "WIR002": "wire-format manifest missing — generate it with "
              "`python -m repro_torch.analysis --write-manifest`",
    "RNG001": "history-ring subscript without a `% HIST` wrap (ring reads "
              "alias silently once an offset outgrows the ring)",
    "RNG002": "HIST build-time capacity guard not found (build() must "
              "validate max RTT / signal-delay offsets against HIST)",
    "UNI001": "arithmetic/comparison mixes incompatible dimensions "
              "(e.g. bytes with us) per the *_us/*_bytes/... naming "
              "convention",
    "UNI002": "same dimension, different scale: unconverted us/ms mixing "
              "(divide or multiply by the conversion factor first)",
    "UNI003": "compound unit mismatch: a derived quantity (rate x time, "
              "bytes/us) meets a plain unit without conversion",
    "UNI004": "assignment target's unit suffix contradicts the unit of "
              "the assigned expression",
    "INV001": "SimState/PacketState field mutated in the step without a "
              "registered runtime invariant or exemption in "
              "repro_torch.netsim.sanitize",
    "INV002": "sanitizer registry rot: coverage/exemption key is not a "
              "state field, or names an unknown invariant",
    "DEV001": "host read of a device value in step-reachable code: "
              ".item()/.tolist()/.cpu()/.numpy(), float()/int()/bool() or "
              "np.asarray()/np.array() (a host sync)",
    "DEV002": "Python if/while/assert/and/or/not/ternary on a device value "
              "in step-reachable code (an implicit bool(), a host sync)",
    "DEV003": "accumulating scatter (index_add_/scatter_add_/"
              "scatter_reduce_/index_put_(accumulate=True)/bincount"
              "(weights=)) into an accumulator whose dtype is not stated "
              "where it is made: on the card the atomics' order shows in "
              "a float sum",
    "DEV004": "data-dependent shape or host build in step-reachable code "
              "(nonzero, unique, masked_select, boolean-mask indexing, "
              "repeat_interleave without output_size, torch.tensor/"
              "as_tensor of host data, dtype-less np constructor): breaks "
              "a CUDA graph",
}

_IGNORE_RE = re.compile(r"#\s*reprolint:\s*ignore\[([A-Z0-9,\s]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-indexed; 0 = whole-file / repo-level finding
    message: str

    def format(self, style: str = "text") -> str:
        if style == "github":
            # GitHub Actions workflow-command annotation
            return (f"::error file={self.path},line={max(self.line, 1)},"
                    f"title=reprolint {self.code}::{self.message}")
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def ignored_codes(source_lines: Sequence[str], line: int) -> FrozenSet[str]:
    """Codes exempted at ``line`` (1-indexed): an ``ignore[...]`` comment
    on the line itself or on the line directly above."""
    out: Set[str] = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(source_lines):
            m = _IGNORE_RE.search(source_lines[ln - 1])
            if m:
                out.update(c.strip() for c in m.group(1).split(","))
    return frozenset(out)


def apply_exemptions(
        findings: Iterable[Finding], sources: Dict[str, List[str]],
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed) using per-line comments.
    ``sources`` maps repo-relative path -> source lines."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        lines = sources.get(f.path, [])
        if f.line > 0 and f.code in ignored_codes(lines, f.line):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed


def dedupe(findings: Iterable[Finding]) -> List[Finding]:
    """First finding per ``(code, path, line)``, in order."""
    seen: Set[Tuple[str, str, int]] = set()
    out: List[Finding] = []
    for f in findings:
        k = (f.code, f.path, f.line)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def render(findings: Sequence[Finding], suppressed: Sequence[Finding],
           num_files: int, style: str = "text") -> str:
    """Render a report in one of the three output formats."""
    if style == "json":
        return json.dumps({
            "findings": [dataclasses.asdict(f) for f in findings],
            "suppressed": len(suppressed),
            "files": num_files,
            "ok": not findings,
        }, indent=2, sort_keys=True)
    lines = [f.format(style) for f in findings]
    if style == "text":
        verdict = "clean" if not findings else f"{len(findings)} finding(s)"
        lines.append(f"reprolint: {verdict} over {num_files} file(s)"
                     f" ({len(suppressed)} suppressed)")
    elif not findings:
        lines.append(f"reprolint: clean over {num_files} file(s)")
    return "\n".join(lines)

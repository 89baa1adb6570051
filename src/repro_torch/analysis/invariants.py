"""INV001/INV002: the static half of the runtime sanitizer contract.

``repro_torch.netsim.sanitize`` holds three registries as module-level
dict literals: ``INVARIANTS`` (name -> check), ``INVARIANT_COVERAGE``
(state field -> invariant names that constrain it) and
``COVERAGE_EXEMPT`` (state field -> why no runtime check applies). This
checker closes the loop statically so the sanitizer can never silently
rot as the engines grow:

- INV001: a ``SimState``/``PacketState`` field is mutated inside the
  step but appears in neither registry: new state slipped in without
  anyone deciding what physical law constrains it. Where the reference
  steps return new states (a ``dataclasses.replace`` keyword), the
  port's steps also write in place, so a field counts as mutated in
  step-reachable code (``astutil``) when it is

  - a ``dataclasses.replace`` keyword;
  - the target of a subscript assignment or augmented assignment,
    ``st.<field>[...] = v`` or ``st.<field> += v``;
  - the receiver of an in-place method, ``st.<field>.copy_(...)``
    (``index_copy_``, ``index_add_``, ``fill_``, ``zero_`` or any other
    ``*_`` tensor method).

  Writes inside the CUDA kernels (``kernels/csrc/*.cu``) are not seen.
- INV002: registry rot: a coverage/exemption key that is not a state
  field, or a coverage entry naming an invariant that does not exist.

Silent when the analyzed files define no state classes (fixture trees,
partial file sets).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import CheckContext, RepoIndex
from repro_torch.analysis.findings import Finding

STATE_CLASSES = ("SimState", "PacketState")
_REGISTRIES = ("INVARIANTS", "INVARIANT_COVERAGE", "COVERAGE_EXEMPT")


def _state_fields(index: RepoIndex) -> Set[str]:
    fields: Set[str] = set()
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and \
                    node.name in STATE_CLASSES:
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and \
                            isinstance(stmt.target, ast.Name):
                        fields.add(stmt.target.id)
    return fields


def _registries(index: RepoIndex
                ) -> Dict[str, List[Tuple[str, str, int, List[str]]]]:
    """name -> [(key, path, line, value-names)] over all dict literals
    assigned to the registry names at module level."""
    out: Dict[str, List[Tuple[str, str, int, List[str]]]] = {
        n: [] for n in _REGISTRIES}
    for mod in index.modules.values():
        for stmt in mod.tree.body:
            # plain or annotated module-level assignment of a dict literal
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
            elif isinstance(stmt, ast.AnnAssign):
                target = stmt.target
            else:
                continue
            if not (isinstance(target, ast.Name)
                    and target.id in _REGISTRIES
                    and isinstance(stmt.value, ast.Dict)):
                continue
            reg = target.id
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                vnames: List[str] = []
                if isinstance(v, (ast.Tuple, ast.List)):
                    vnames = [e.value for e in v.elts
                              if isinstance(e, ast.Constant)
                              and isinstance(e.value, str)]
                elif isinstance(v, ast.Constant) and \
                        isinstance(v.value, str) and \
                        reg == "INVARIANT_COVERAGE":
                    vnames = [v.value]
                out[reg].append((k.value, mod.path, k.lineno, vnames))
    return out


def _state_field(node: ast.AST, fields: Set[str]) -> Optional[str]:
    """``f`` where ``node`` is ``<name>.f`` (or a subscript of it) for a
    state field ``f``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in fields and \
            isinstance(node.value, ast.Name):
        return node.attr
    return None


def _step_mutations(index: RepoIndex,
                    fields: Set[str]) -> List[Tuple[str, str, int]]:
    """(field, path, line) for every state field the step-reachable code
    mutates, in any of the three forms of the module docstring."""
    out: List[Tuple[str, str, int]] = []
    for key in sorted(index.step_reachable()):
        fi = index.funcs[key]
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call):
                f = node.func
                is_replace = (isinstance(f, ast.Attribute)
                              and f.attr == "replace") or \
                             (isinstance(f, ast.Name) and f.id == "replace")
                if is_replace:
                    kws = {kw.arg for kw in node.keywords if kw.arg}
                    for fname in sorted(kws & fields):
                        out.append((fname, fi.path, node.lineno))
                elif isinstance(f, ast.Attribute) and \
                        f.attr.endswith("_") and not f.attr.startswith("_"):
                    fname = _state_field(f.value, fields)
                    if fname is not None:
                        out.append((fname, fi.path, node.lineno))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript) or \
                            isinstance(node, ast.AugAssign):
                        fname = _state_field(tgt, fields)
                        if fname is not None:
                            out.append((fname, fi.path, node.lineno))
    return out


def check_invariants(ctx: CheckContext) -> List[Finding]:
    index: RepoIndex = ctx.index
    fields = _state_fields(index)
    if not fields:
        return []
    regs = _registries(index)
    covered = {k for k, _, _, _ in regs["INVARIANT_COVERAGE"]}
    exempt = {k for k, _, _, _ in regs["COVERAGE_EXEMPT"]}
    inv_names = {k for k, _, _, _ in regs["INVARIANTS"]}

    findings: List[Finding] = []
    flagged: Set[str] = set()
    for fname, path, line in _step_mutations(index, fields):
        if fname in covered or fname in exempt or fname in flagged:
            continue
        flagged.add(fname)
        findings.append(Finding(
            code="INV001", path=path, line=line,
            message=f"state field `{fname}` is mutated in the step but "
                    f"has no registered runtime invariant "
                    f"(INVARIANT_COVERAGE) and no exemption "
                    f"(COVERAGE_EXEMPT) in repro_torch.netsim.sanitize"))

    for reg in ("INVARIANT_COVERAGE", "COVERAGE_EXEMPT"):
        for k, path, line, vnames in regs[reg]:
            if k not in fields:
                findings.append(Finding(
                    code="INV002", path=path, line=line,
                    message=f"{reg} key `{k}` is not a SimState/"
                            f"PacketState field — stale registry entry"))
            for v in vnames:
                if v not in inv_names:
                    findings.append(Finding(
                        code="INV002", path=path, line=line,
                        message=f"{reg}[`{k}`] names invariant `{v}` "
                                f"which is not in INVARIANTS"))

    seen: Set[Tuple[str, str, int, str]] = set()
    out: List[Finding] = []
    for f in findings:
        key = (f.code, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out

"""AXS001-AXS003: the ExpSpec sweep-axis contract.

The sweep engine compiles once per *static key* and runs every cell that
shares it; a field routed the wrong way either recompiles per cell
(static data in a dynamic axis is fine — dynamic data in the trace key
is not) or silently bakes one cell's value into every other cell.

The contract is declared next to the dataclass::

    AXES_STATIC  = ("cc", "engine", ...)   # members of the trace key
    AXES_DYNAMIC = ("load", "seed", ...)   # padded per-cell arrays
    AXES_EXEMPT  = {"topology": "why"}     # neither, with justification

and cross-checked against how ``spec_to_cfg`` actually consumes fields:

- AXS001: a field missing from all three tables, listed twice, or a
  table entry that is not a field at all.
- AXS002: declared dynamic but read by ``spec_to_cfg`` — its value
  would enter the trace key and recompile every sweep cell.
- AXS003: declared static but never read by ``spec_to_cfg`` — it never
  reaches the trace key, so cells differing only in it would share one
  compiled (and wrong) configuration.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import CheckContext, ModuleInfo, RepoIndex
from repro_torch.analysis.findings import Finding

SPEC_CLASS = "ExpSpec"
CFG_FUNC = "spec_to_cfg"


def _str_elts(node: ast.AST) -> Optional[List[str]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def _extract(mod: ModuleInfo) -> Optional[Tuple[
        ast.ClassDef, List[str], Dict[str, Tuple[int, List[str]]],
        Set[str], bool]]:
    """(class node, field names, tables, spec_to_cfg reads) or None."""
    cls = None
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == SPEC_CLASS:
            cls = node
            break
    if cls is None:
        return None

    fields: List[str] = []
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name):
            fields.append(stmt.target.id)

    tables: Dict[str, Tuple[int, object]] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("AXES_STATIC", "AXES_DYNAMIC"):
                elts = _str_elts(node.value)
                if elts is not None:
                    tables[name] = (node.lineno, elts)
            elif name == "AXES_EXEMPT" and isinstance(node.value, ast.Dict):
                keys = []
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                  str):
                        keys.append(k.value)
                tables[name] = (node.lineno, keys)

    reads: Set[str] = set()
    cfg_fn = mod.funcs.get(CFG_FUNC)
    if cfg_fn is not None and isinstance(cfg_fn.node, ast.FunctionDef):
        fn = cfg_fn.node
        if fn.args.args:
            spec_name = fn.args.args[0].arg
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) and \
                        isinstance(n.value, ast.Name) and \
                        n.value.id == spec_name:
                    reads.add(n.attr)
    return cls, fields, tables, reads, cfg_fn is not None


def check_axes(ctx: CheckContext) -> List[Finding]:
    index: RepoIndex = ctx.index
    findings: List[Finding] = []
    for mod in index.modules.values():
        got = _extract(mod)
        if got is None:
            continue
        cls, fields, tables, reads, has_cfg = got

        missing_tables = [t for t in ("AXES_STATIC", "AXES_DYNAMIC",
                                      "AXES_EXEMPT") if t not in tables]
        if missing_tables:
            findings.append(Finding(
                code="AXS001", path=mod.path, line=cls.lineno,
                message=f"{SPEC_CLASS} has no "
                        f"{'/'.join(missing_tables)} table(s) — every "
                        f"sweep axis must be declared static, dynamic, "
                        f"or exempt-with-justification"))
            continue

        line_static, static = tables["AXES_STATIC"]
        line_dynamic, dynamic = tables["AXES_DYNAMIC"]
        line_exempt, exempt = tables["AXES_EXEMPT"]
        declared = list(static) + list(dynamic) + list(exempt)

        for field in fields:
            n = declared.count(field)
            if n == 0:
                findings.append(Finding(
                    code="AXS001", path=mod.path, line=cls.lineno,
                    message=f"field `{field}` is in no AXES_* table — "
                            f"classify it static, dynamic, or exempt"))
            elif n > 1:
                findings.append(Finding(
                    code="AXS001", path=mod.path, line=line_static,
                    message=f"field `{field}` appears in more than one "
                            f"AXES_* table"))
        for name in declared:
            if name not in fields:
                findings.append(Finding(
                    code="AXS001", path=mod.path, line=line_static,
                    message=f"AXES_* entry `{name}` is not an "
                            f"{SPEC_CLASS} field"))

        if has_cfg:
            for field in dynamic:
                if field in reads and field not in exempt:
                    findings.append(Finding(
                        code="AXS002", path=mod.path, line=line_dynamic,
                        message=f"axis `{field}` is declared dynamic "
                                f"but read by {CFG_FUNC} — its value "
                                f"enters the trace key and recompiles "
                                f"every sweep cell"))
            for field in static:
                if field not in reads and field not in exempt:
                    findings.append(Finding(
                        code="AXS003", path=mod.path, line=line_static,
                        message=f"axis `{field}` is declared static but "
                                f"{CFG_FUNC} never reads it — it cannot "
                                f"reach the trace key, so cells "
                                f"differing only in it share one "
                                f"compiled config"))
    return findings

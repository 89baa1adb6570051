"""RNG001/RNG002: history-ring indexing discipline.

The engine keeps per-link history rings (``hist_c``/``hist_q``/
``hist_u``/``hist_pause``) of depth ``HIST`` and addresses them with
wrapped slots (``t % HIST``, ``(t - delay) % HIST``). A read whose slot
is *not* wrapped does not crash — it aliases once the offset outgrows
the ring, which is exactly the silent-staleness bug class the build-time
guard (``max offset >= HIST -> raise``) exists to prevent.

RNG001 flags any subscript into a ring (or a local alias of one, e.g.
``pause_flat = hist_pause.reshape(-1)``) whose index expression neither
contains a literal ``% HIST`` nor references a wrapped local. Constant
indices are exempt — a fixed slot cannot outgrow the ring.

RNG002 fires once per run when ring names are used anywhere but no
build-time capacity guard (an ``if`` comparing against ``HIST`` whose
body raises) exists in the analyzed files.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.astutil import CheckContext, FuncInfo, ModuleInfo, RepoIndex
from repro_torch.analysis.findings import Finding

RING_NAMES = ("hist_c", "hist_q", "hist_u", "hist_pause")


def _mentions_ring(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in RING_NAMES:
            return True
        if isinstance(n, ast.Attribute) and n.attr in RING_NAMES:
            return True
    return False


def _mentions_any(node: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def _has_mod_hist(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod):
            r = n.right
            if isinstance(r, ast.Name) and r.id == "HIST":
                return True
            if isinstance(r, ast.Attribute) and r.attr == "HIST":
                return True
    return False


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _wrapped_locals(fn: ast.AST) -> Set[str]:
    """Locals provably derived from a ``% HIST`` wrap, to a fixpoint."""
    wrapped: Set[str] = set()
    for _ in range(4):
        before = len(wrapped)
        for stmt in ast.walk(fn):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            value = stmt.value
            if value is None:
                continue
            if _has_mod_hist(value) or _mentions_any(value, wrapped):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            wrapped.add(n.id)
        if len(wrapped) == before:
            break
    return wrapped


def _ring_aliases(fn: ast.AST) -> Set[str]:
    """Locals assigned from an expression that mentions a ring but does
    not subscript it (e.g. ``flat = st.hist_c.reshape(-1)``)."""
    aliases: Set[str] = set()
    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and _mentions_ring(stmt.value):
            if not any(isinstance(n, ast.Subscript)
                       for n in ast.walk(stmt.value)):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
    return aliases


def _check_function(mod: ModuleInfo, fi: FuncInfo,
                    findings: List[Finding]) -> None:
    fn = fi.node
    wrapped = _wrapped_locals(fn)
    aliases = _ring_aliases(fn)

    for node in ast.walk(fn):
        if not isinstance(node, ast.Subscript):
            continue
        base = node.value
        is_ring = _mentions_ring(base) or _mentions_any(base, aliases)
        if not is_ring:
            continue
        idx = node.slice
        idx_names = _names_in(idx) - {"HIST", "jnp", "jax", "np", "lax"}
        if not idx_names:
            continue                      # constant slot: cannot outgrow
        if _has_mod_hist(idx) or (idx_names & wrapped):
            continue
        findings.append(Finding(
            code="RNG001", path=mod.path, line=node.lineno,
            message=f"ring subscript in `{fi.qual}` indexes a history "
                    f"ring without a `% HIST` wrap — reads alias "
                    f"silently once the offset outgrows the ring"))


def _has_capacity_guard(mod: ModuleInfo) -> bool:
    """An ``if`` comparing something against HIST whose body raises."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.If):
            continue
        test_names = _names_in(node.test) | {
            n.attr for n in ast.walk(node.test)
            if isinstance(n, ast.Attribute)}
        if "HIST" not in test_names:
            continue
        if not any(isinstance(n, ast.Compare)
                   for n in ast.walk(node.test)) and \
                not isinstance(node.test, ast.Compare):
            continue
        if any(isinstance(s, ast.Raise) for b in [node.body]
               for s in ast.walk(ast.Module(body=b, type_ignores=[]))):
            return True
    return False


def check_rings(ctx: CheckContext) -> List[Finding]:
    index: RepoIndex = ctx.index
    findings: List[Finding] = []
    rings_used = False
    guard_found = False
    guard_mods: List[str] = []
    for mod in index.modules.values():
        uses = _mentions_ring(mod.tree)
        if uses:
            rings_used = True
            for fi in mod.funcs.values():
                if isinstance(fi.node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    _check_function(mod, fi, findings)
        if _has_capacity_guard(mod):
            guard_found = True
            guard_mods.append(mod.path)
    if rings_used and not guard_found:
        findings.append(Finding(
            code="RNG002", path="", line=0,
            message="history rings are used but no build-time capacity "
                    "guard (`if <max offset> >= HIST: raise`) exists — "
                    "ring wraps are only sound when build() validates "
                    "every RTT / signal-delay offset against HIST"))
    # dedupe (nested functions are walked by their parents too)
    seen = set()
    out = []
    for f in findings:
        k = (f.code, f.path, f.line)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out

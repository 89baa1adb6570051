"""UNI001-UNI004: conservative dimension-flow analysis over the naming
conventions the codebase already follows everywhere (``*_us``, ``*_ms``,
``*_bytes``, ``*_gbps``, ``*_km``).

A unit is a reduced fraction over the base tokens — ``us``,
``bytes/us``, ``gbps*us`` — seeded from name/attribute suffixes and
propagated through assignments, arithmetic, and a whitelist of
unit-preserving calls. The analysis only flags *provable* mismatches:

- multiplying or dividing by a bare numeric literal erases the unit
  (it is how conversions are written — ``y_us / 1000`` is the µs→ms
  idiom, ``cap_gbps * 125.0`` the Gbps→bytes/µs one), so a converted
  value never false-positives;
- unknown values (unsuffixed names, unresolved calls) are compatible
  with everything;
- dimensionless ratios (``us/us``) are compatible with everything.

What still fires is the real bug class: ``delay_us + gap_ms`` (UNI002),
``q_bytes > horizon_us`` (UNI001), ``q_bytes + rate_gbps * dt_us``
without the 125 conversion (UNI003), ``delay_us = dist_km`` (UNI004).
``UNITS_OVERRIDES`` corrects names whose spelling lies about (or hides)
their unit.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import (
    CheckContext, FuncInfo, ModuleInfo, RepoIndex, ValueFlow,
)
from repro_torch.analysis.findings import Finding

# base dimension tokens recognized as name suffixes ("x_us", "size_bytes")
BASE_TOKENS = ("us", "ms", "bytes", "gbps", "km")
# token -> physical dimension (us and ms share one: mixing them is a
# *scale* bug — UNI002 — not a dimension bug)
_DIM = {"us": "time", "ms": "time", "bytes": "data", "gbps": "rate",
        "km": "length"}

# name -> unit token (or None to silence inference for that name).
# The escape hatch for spellings the suffix convention gets wrong.
UNITS_OVERRIDES: Dict[str, Optional[str]] = {
    "path_prop": "us",        # engine.SimArrays: per-path propagation, µs
    "arrival_us": "us",
    "prop": "us",
    # workload CDF tables: "kb"-named but stored in bytes post-parse
    "mean_kb": None,
}

# A unit is a reduced fraction (numerator tokens, denominator tokens),
# both sorted. DIMLESS is the empty fraction; ANY marks bare literals
# (compatible with everything in additive/compare positions); None means
# "no information".
Unit = Tuple[Tuple[str, ...], Tuple[str, ...]]
DIMLESS: Unit = ((), ())
ANY = "any"

# calls that return their first argument's unit unchanged
_PASS_FUNCS = {"float", "int", "abs", "round", "asarray", "array", "sum",
               "mean", "median", "cumsum", "floor", "ceil", "sort",
               "sqrt_preserving", "squeeze", "ravel", "reshape", "take",
               "amax", "amin", "max", "min", "nanmax", "nanmin",
               "percentile", "quantile", "block_until_ready"}
# receiver-preserving method calls (x.astype(...), fq.sum(-1), ...)
_PASS_METHODS = {"astype", "sum", "mean", "max", "min", "clip", "reshape",
                 "squeeze", "ravel", "flatten", "cumsum", "take", "sort",
                 "copy", "any", "all", "item"}
# joins: every data argument must be unit-compatible; result is the merge
_JOIN_FUNCS = {"maximum", "minimum", "fmax", "fmin", "hypot"}


def name_unit(name: str) -> Optional[Unit]:
    """Unit a bare name or attribute spelling declares, if any."""
    if name in UNITS_OVERRIDES:
        tok = UNITS_OVERRIDES[name]
        return ((tok,), ()) if tok else None
    tail = name.rsplit("_", 1)[-1]
    if tail in BASE_TOKENS:
        return ((tail,), ())
    return None


def _mul(a: Unit, b: Unit) -> Unit:
    num = list(a[0]) + list(b[0])
    den = list(a[1]) + list(b[1])
    for tok in list(num):          # cancel us/us etc.
        if tok in den:
            num.remove(tok)
            den.remove(tok)
    return (tuple(sorted(num)), tuple(sorted(den)))


def _inv(a: Unit) -> Unit:
    return (a[1], a[0])


def _is_compound(u: Unit) -> bool:
    return len(u[0]) + len(u[1]) != 1 or bool(u[1])


def _fmt(u: Unit) -> str:
    if u == DIMLESS:
        return "dimensionless"
    num = "*".join(u[0]) or "1"
    return f"{num}/{'*'.join(u[1])}" if u[1] else num


def _mismatch_code(a: Unit, b: Unit) -> str:
    if _is_compound(a) or _is_compound(b):
        return "UNI003"
    return "UNI002" if _DIM[a[0][0]] == _DIM[b[0][0]] else "UNI001"


class _UnitFlow(ValueFlow):
    """Statement walker with a parallel name -> Unit environment.

    Reuses ValueFlow's statement dispatch (and two-pass loop settling);
    the unit evaluation happens in pre-hooks so every expression a
    statement evaluates is also unit-checked.
    """

    def __init__(self, mod: ModuleInfo, fi: FuncInfo,
                 init_env: Optional[Dict[str, int]],
                 init_units: Optional[Dict[str, object]],
                 findings: List[Finding]) -> None:
        super().__init__(mod, fi, init_env)
        self.units: Dict[str, object] = dict(init_units or {})
        self.findings = findings
        # seed parameter units from their names (def f(dt_us, size_bytes))
        node = fi.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                u = name_unit(a.arg)
                if u is not None:
                    self.units[a.arg] = u

    def _emit(self, code: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            code=code, path=self.mod.path,
            line=getattr(node, "lineno", 0),
            message=f"{msg} [in `{self.fi.qual}`]"))

    # ------------------------------------------------- statement pre-hooks
    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            u = self.unit(stmt.value)
            for tgt in stmt.targets:
                self._bind_unit(tgt, u, stmt)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind_unit(stmt.target, self.unit(stmt.value), stmt)
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name):
                tu = self._name_lookup(stmt.target.id)
                r = self._binop_unit(stmt.op, tu, self.unit(stmt.value),
                                     stmt)
                if r is not ANY:
                    self.units[stmt.target.id] = r
            else:
                self.unit(stmt.value)
        elif isinstance(stmt, (ast.If, ast.While)):
            self.unit(stmt.test)
        elif isinstance(stmt, ast.Assert):
            self.unit(stmt.test)
        elif isinstance(stmt, (ast.Return, ast.Expr)) and \
                stmt.value is not None:
            self.unit(stmt.value)
        super()._stmt(stmt)

    def _bind_unit(self, target: ast.expr, u: object,
                   stmt: ast.stmt) -> None:
        if isinstance(target, ast.Name):
            declared = name_unit(target.id)
            if declared is not None:
                if (isinstance(u, tuple) and u not in (DIMLESS, declared)):
                    self._emit(
                        "UNI004", stmt,
                        f"`{target.id}` declares unit {_fmt(declared)} by "
                        f"its suffix but is assigned a value of unit "
                        f"{_fmt(u)}")
                self.units[target.id] = declared   # trust the declaration
            elif isinstance(u, tuple):
                self.units[target.id] = u
            else:
                self.units.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_unit(elt, None, stmt)

    def _name_lookup(self, name: str) -> object:
        if name in self.units:
            return self.units[name]
        return name_unit(name)

    # ------------------------------------------------------ unit evaluator
    def _check(self, a: object, b: object, node: ast.AST,
               what: str) -> None:
        if not (isinstance(a, tuple) and isinstance(b, tuple)):
            return
        if a == b or DIMLESS in (a, b):
            return
        self._emit(_mismatch_code(a, b), node,
                   f"{what} mixes {_fmt(a)} with {_fmt(b)}")

    def _merge(self, a: object, b: object) -> object:
        if a is ANY:
            return b
        if b is ANY:
            return a
        if isinstance(a, tuple) and isinstance(b, tuple) and a == b:
            return a
        return None

    def _binop_unit(self, op: ast.operator, lu: object, ru: object,
                    node: ast.AST) -> object:
        if isinstance(op, (ast.Add, ast.Sub)):
            self._check(lu, ru, node,
                        "`-`" if isinstance(op, ast.Sub) else "`+`")
            return self._merge(lu, ru)
        if isinstance(op, ast.Mult):
            if lu is ANY or ru is ANY:
                return None        # literal factor = conversion license
            if isinstance(lu, tuple) and isinstance(ru, tuple):
                return _mul(lu, ru)
            return None
        if isinstance(op, (ast.Div, ast.FloorDiv)):
            if lu is ANY or ru is ANY:
                return None
            if isinstance(lu, tuple) and isinstance(ru, tuple):
                return _mul(lu, _inv(ru))
            return None
        if isinstance(op, ast.Mod):
            return lu if isinstance(lu, tuple) else None
        return None

    def unit(self, node: ast.expr) -> object:
        if isinstance(node, ast.Constant):
            return ANY
        if isinstance(node, ast.Name):
            return self._name_lookup(node.id)
        if isinstance(node, ast.Attribute):
            return name_unit(node.attr)
        if isinstance(node, ast.Subscript):
            self.unit(node.slice)
            return self.unit(node.value)
        if isinstance(node, ast.BinOp):
            return self._binop_unit(node.op, self.unit(node.left),
                                    self.unit(node.right), node)
        if isinstance(node, ast.UnaryOp):
            return self.unit(node.operand)
        if isinstance(node, ast.Compare):
            lu = self.unit(node.left)
            for cmp_ in node.comparators:
                self._check(lu, self.unit(cmp_), node, "comparison")
            return None
        if isinstance(node, ast.IfExp):
            self.unit(node.test)
            bu, ou = self.unit(node.body), self.unit(node.orelse)
            self._check(bu, ou, node, "conditional branches")
            return self._merge(bu, ou)
        if isinstance(node, ast.Call):
            return self._call_unit(node)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self.unit(v)
            return None
        if isinstance(node, ast.NamedExpr):
            u = self.unit(node.value)
            self._bind_unit(node.target, u, node)
            return u
        # generic: evaluate child expressions (to surface nested
        # comparisons/binops), contribute no unit
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self.unit(child)
        return None

    def _call_unit(self, node: ast.Call) -> object:
        f = node.func
        arg_units = [self.unit(a) for a in node.args]
        for kw in node.keywords:
            self.unit(kw.value)
        last = None
        if isinstance(f, ast.Name):
            last = f.id
        elif isinstance(f, ast.Attribute):
            last = f.attr
        if last in _JOIN_FUNCS and len(arg_units) >= 2:
            self._check(arg_units[0], arg_units[1], node, f"`{last}`")
            return self._merge(arg_units[0], arg_units[1])
        if last == "where" and len(arg_units) == 3:
            self._check(arg_units[1], arg_units[2], node, "`where` arms")
            return self._merge(arg_units[1], arg_units[2])
        if last == "clip" and arg_units:
            for bound in arg_units[1:3]:
                self._check(arg_units[0], bound, node, "`clip` bound")
            return arg_units[0]
        if last in _PASS_FUNCS and isinstance(f, (ast.Name, ast.Attribute)):
            if arg_units:
                return arg_units[0]
            # method form: unit of the receiver
            if isinstance(f, ast.Attribute):
                return self.unit(f.value)
            return None
        if isinstance(f, ast.Attribute) and last in _PASS_METHODS:
            return self.unit(f.value)
        # `.at[...].set(v)` / `.add(v)`: unit of the underlying array
        if isinstance(f, ast.Attribute) and isinstance(f.value,
                                                       ast.Subscript):
            base = f.value.value
            if isinstance(base, ast.Attribute) and base.attr == "at":
                return self.unit(base.value)
        # a helper spelled with a unit suffix declares its return unit
        if last is not None:
            u = name_unit(last)
            if u is not None:
                return u
        return None


def check_units(ctx: CheckContext) -> List[Finding]:
    """Run the unit flow over every function in the index (skipping test
    code, where synthetic constants mix freely)."""
    index: RepoIndex = ctx.index
    findings: List[Finding] = []
    unit_envs: Dict[str, Dict[str, object]] = {}
    lattice_envs: Dict[str, Dict[str, int]] = {}
    keys = [k for k, fi in index.funcs.items()
            if not fi.path.startswith("tests/")
            and isinstance(fi.node, (ast.FunctionDef, ast.AsyncFunctionDef))]
    # parents before nested so closures inherit both environments
    for key in sorted(keys, key=lambda k: (index.funcs[k].path,
                                           index.funcs[k].qual.count("."),
                                           index.funcs[k].qual)):
        fi = index.funcs[key]
        mod = index.modules[fi.path]
        init_l: Dict[str, int] = {}
        init_u: Dict[str, object] = {}
        if fi.parent is not None:
            init_l = lattice_envs.get(f"{fi.path}::{fi.parent}", {})
            init_u = unit_envs.get(f"{fi.path}::{fi.parent}", {})
        flow = _UnitFlow(mod, fi, init_l, init_u, findings)
        lattice_envs[key] = flow.run()
        unit_envs[key] = flow.units

    seen: Set[Tuple[str, str, int]] = set()
    out: List[Finding] = []
    for f in findings:
        k = (f.code, f.path, f.line)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out

"""DEV001-DEV004: host syncs and CUDA-graph hazards in step-reachable code.

The counterpart of the reference's ``tracing`` family (TRC001-TRC004).
A JAX tracer raises on a host read; a CUDA tensor does not, it waits
for the card. So the port's contract, that an engine step after step 0
and a decode step make no host sync and keep their shapes fixed (queue B
of ROADMAP.md captures them in CUDA graphs), is held here statically.

Reachability is seeded from the port's step bodies (``STEP_QUALS``:
``netsim/fluid.py``'s and ``netsim/packet.py``'s ``make_step.step``,
``serve/decode.py``'s ``decode_step``) and follows the launcher
indirections ``astutil`` documents. A nested function starts from its
enclosing function's environment, so a closure's ``ar`` is as DEVICE as
the ``ar: SimArrays`` it closes over.

The dataflow only flags values it can prove DEVICE, so host config reads
(``cfg.dt_us``), tensor metadata (``x.shape``, ``x.numel()``) and
unresolved helpers never fire.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.astutil import (
    DEVICE, CheckContext, FuncInfo, ModuleInfo, RepoIndex, ValueFlow,
    dotted_name, param_names,
)
from repro_torch.analysis.findings import Finding, dedupe

_CAST_FUNCS = {"float", "int", "bool"}
_NP_CASTS = {"numpy.asarray", "numpy.array"}
_NP_CTORS = {"array", "asarray", "zeros", "ones", "full", "empty",
             "arange", "linspace", "eye"}
# accumulating scatters (in place and functional)
_ACCUM = {"index_add_", "index_add", "scatter_add_", "scatter_add",
          "scatter_reduce_", "scatter_reduce"}
# constructors of a fresh tensor, and the casts that state a dtype
_MAKERS = {"zeros", "ones", "empty", "full", "zeros_like", "ones_like",
           "empty_like", "full_like", "new_zeros", "new_ones", "new_empty",
           "new_full", "tensor", "arange"}
_CASTS = {"to", "double", "float", "half", "bfloat16", "long", "int",
          "short", "bool", "type"}
# calls that keep their receiver's dtype
_SAME_DTYPE = {"clone", "contiguous", "reshape", "view", "flatten",
               "squeeze", "unsqueeze", "detach", "expand", "permute",
               "transpose", "movedim"}
# ops whose output shape depends on the data
_DATA_SHAPE = {"nonzero", "argwhere", "unique", "unique_consecutive",
               "masked_select"}
# calls whose result is a boolean mask
_BOOL_CALLS = {"isfinite", "isnan", "isinf", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "isin", "eq", "ne", "lt", "le", "gt", "ge", "bool",
               "signbit"}


class _SyncFlow(ValueFlow):
    def __init__(self, mod: ModuleInfo, fi: FuncInfo,
                 init_env: Optional[Dict[str, int]],
                 init_makers: Optional[Dict[str, ast.expr]],
                 findings: Optional[List[Finding]],
                 index: RepoIndex) -> None:
        self.findings = findings
        self.makers: Dict[str, ast.expr] = dict(init_makers or {})
        super().__init__(mod, fi, init_env, index)
        for name in param_names(fi.node):
            self.makers.pop(name, None)       # a parameter is made elsewhere

    def _emit(self, code: str, node: ast.AST, msg: str) -> None:
        if self.findings is not None:
            self.findings.append(Finding(
                code=code, path=self.mod.path,
                line=getattr(node, "lineno", 0),
                message=f"{msg} [in `{self.fi.qual}`]"))

    def on_bind(self, name: str, value: Optional[ast.expr]) -> None:
        if value is None:
            self.makers.pop(name, None)
        else:
            self.makers[name] = value

    # ------------------------------------------------------------ hooks
    def on_call(self, node: ast.Call, arg_classes: List[int],
                recv_class: Optional[int]) -> None:
        d = self.call_name(node)
        is_torch = (d or "").startswith("torch.")
        f = node.func
        meth = f.attr if isinstance(f, ast.Attribute) else None
        recv_dev = recv_class == DEVICE
        arg_dev = any(c == DEVICE for c in arg_classes)

        # DEV001: host reads
        if d in _CAST_FUNCS and arg_dev:
            self._emit("DEV001", node,
                       f"`{d}()` of a device value reads it back to the "
                       f"host (a sync); keep it a tensor or hoist it to "
                       f"set-up")
        elif d in _NP_CASTS and arg_dev:
            self._emit("DEV001", node,
                       f"`{d}()` of a device value copies it to the host "
                       f"(a sync)")
        elif recv_dev and meth in ("item", "tolist", "cpu", "numpy"):
            self._emit("DEV001", node,
                       f"`.{meth}()` of a device value reads it back to "
                       f"the host (a sync)")

        # DEV003: accumulating scatters into an unstated dtype
        if meth in _ACCUM and recv_dev:
            self._accum(node, f.value, meth)
        elif meth in ("index_put_", "index_put") and recv_dev and (
                any(kw.arg == "accumulate" and not _is_false(kw.value)
                    for kw in node.keywords)
                or (len(node.args) >= 3 and not _is_false(node.args[2]))):
            self._accum(node, f.value, meth)
        if (d == "torch.bincount" or (meth == "bincount" and recv_dev)) and \
                any(kw.arg == "weights" for kw in node.keywords):
            w = next(kw.value for kw in node.keywords if kw.arg == "weights")
            if not self._stated(w):
                self._emit("DEV003", node,
                           "`bincount(weights=...)` sums in the weights' "
                           "dtype, which is not stated where they are "
                           "made: state it (a float64 sum) so the order "
                           "of the card's atomics does not show")

        # DEV004: data-dependent shapes and host builds
        name = meth if meth is not None and not is_torch else \
            (d or "").rsplit(".", 1)[-1]
        if name in _DATA_SHAPE and (is_torch or recv_dev):
            self._emit("DEV004", node,
                       f"`{name}` has a data-dependent output shape: it "
                       f"reads a count back to the host (a sync) and "
                       f"cannot be captured in a CUDA graph")
        elif d == "torch.where" and len(node.args) == 1 and \
                not node.keywords:
            self._emit("DEV004", node,
                       "one-argument `torch.where` is `nonzero`: a "
                       "data-dependent output shape")
        elif name == "repeat_interleave" and (is_torch or recv_dev) and \
                not any(kw.arg == "output_size" for kw in node.keywords):
            reps = node.args[1] if is_torch and len(node.args) > 1 else \
                (node.args[0] if not is_torch and node.args else None)
            if reps is not None and self.expr(reps) == DEVICE:
                self._emit("DEV004", node,
                           "`repeat_interleave` with tensor repeats and no "
                           "`output_size=` reads the total back to the "
                           "host")
        elif d in ("torch.tensor", "torch.as_tensor") and node.args and \
                arg_classes[0] != DEVICE:
            self._emit("DEV004", node,
                       f"`{d}(...)` of host data copies it to the card "
                       f"each call (a synchronizing copy from pageable "
                       f"memory): build it once at set-up, or fill it on "
                       f"the card (`torch.full`)")
        elif d is not None and d.startswith("numpy.") and \
                name in _NP_CTORS:
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
            pos_ok = len(node.args) >= (3 if name == "full" else 2) \
                and name not in ("arange", "linspace")
            if not has_dtype and not pos_ok:
                self._emit("DEV004", node,
                           f"`{d}(...)` without dtype= builds a float64 "
                           f"host array that upcasts what it meets")

    def on_branch(self, node: ast.AST, test_class: int) -> None:
        if test_class != DEVICE:
            return
        kind = {ast.While: "while", ast.Assert: "assert",
                ast.IfExp: "ternary", ast.BoolOp: "and/or",
                ast.UnaryOp: "not"}.get(type(node), "if")
        self._emit("DEV002", node,
                   f"Python `{kind}` on a device value calls bool() on it "
                   f"(a sync); use torch.where or a host-side schedule")

    def on_subscript(self, node: ast.Subscript, value_class: int,
                     index_class: int) -> None:
        if not isinstance(node.ctx, ast.Load) or index_class != DEVICE:
            return
        parts = node.slice.elts if isinstance(node.slice, ast.Tuple) \
            else [node.slice]
        if any(self._is_mask(p) for p in parts):
            self._emit("DEV004", node,
                       "boolean-mask indexing has a data-dependent output "
                       "shape (a `nonzero` and a sync); use torch.where")

    # ---------------------------------------------------------- helpers
    def _maker(self, node: ast.expr) -> Optional[ast.expr]:
        """The expression that made ``node``'s tensor, through local
        names and dtype-keeping views; None where it is not visible."""
        for _ in range(8):
            if isinstance(node, ast.Name):
                if node.id not in self.makers:
                    return None
                node = self.makers[node.id]
            elif isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SAME_DTYPE:
                node = node.func.value
            else:
                return node
        return None

    def _stated(self, node: ast.expr) -> bool:
        """Whether the dtype of ``node``'s tensor is stated where it is
        made (or the maker is not visible here)."""
        made = self._maker(node)
        if not isinstance(made, ast.Call):
            return True
        name = _callee(made)
        if name in _CASTS and isinstance(made.func, ast.Attribute):
            return True
        if name in _MAKERS or name in _ACCUM:
            return any(kw.arg == "dtype" for kw in made.keywords)
        return True

    def _accum(self, node: ast.Call, recv: ast.expr, meth: str) -> None:
        if not self._stated(recv):
            self._emit("DEV003", node,
                       f"`.{meth}(...)` accumulates into a tensor whose "
                       f"dtype is not stated where it is made: on the card "
                       f"the order of the atomics shows in a float sum; "
                       f"make the accumulator with an explicit dtype (a "
                       f"float64 sum)")

    def _is_mask(self, node: ast.expr, depth: int = 0) -> bool:
        if depth > 8:
            return False
        if isinstance(node, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand, depth + 1)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return (self._is_mask(node.left, depth + 1)
                    or self._is_mask(node.right, depth + 1))
        if isinstance(node, ast.Subscript):
            return self._is_mask(node.value, depth + 1)
        if isinstance(node, ast.Name) and node.id in self.makers:
            return self._is_mask(self.makers[node.id], depth + 1)
        if isinstance(node, ast.Call):
            name = _callee(node)
            if name in _BOOL_CALLS:
                return True
            if name == "to" and any(dotted_name(a) == "torch.bool"
                                    for a in node.args):
                return True
        return False


def _callee(node: ast.Call) -> Optional[str]:
    """The last name of a call's callee (``x.to`` -> "to")."""
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else \
        (f.id if isinstance(f, ast.Name) else None)


def _is_false(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value in (False, None, 0)


def check_syncs(ctx: CheckContext) -> List[Finding]:
    index: RepoIndex = ctx.index
    reach = index.step_reachable()
    findings: List[Finding] = []
    envs: Dict[str, Dict[str, int]] = {}
    makers: Dict[str, Dict[str, ast.expr]] = {}

    def env_of(key: str) -> None:
        """Run ``key``'s flow (its parents first) into ``envs``; emit
        findings only for reachable functions."""
        if key in envs:
            return
        fi = index.funcs[key]
        pkey = f"{fi.path}::{fi.parent}" if fi.parent else None
        if pkey is not None and pkey in index.funcs:
            env_of(pkey)
        flow = _SyncFlow(index.modules[fi.path], fi,
                         envs.get(pkey, {}) if pkey else {},
                         makers.get(pkey, {}) if pkey else {},
                         findings if key in reach else None, index)
        envs[key] = flow.run()
        makers[key] = flow.makers

    for key in sorted(reach):
        env_of(key)
    return dedupe(findings)

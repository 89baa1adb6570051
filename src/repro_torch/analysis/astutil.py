"""AST plumbing shared by the checkers: the file index, the import-aware
call graph, step reachability, and a small host-vs-device dataflow.

Everything here is *heuristic but conservative in the flagging
direction*: the ``syncs`` checker only fires on values the dataflow can
prove DEVICE, so an unresolved helper call (UNKNOWN) never produces a
finding. Reachability over-approximates (defining a nested function, or
passing a function as an argument, counts as calling it), which is the
right bias for hazard checks: an unreachable function is never
inspected.

Reachability follows the port's own indirections, which the reference
linter's resolver does not:

- tuple-unpacked closures: ``tick, route, decide = step_phases(ar, cfg)``
  binds each name to what ``step_phases`` returns at that position,
  nested defs on one branch and bound methods of a launcher object
  (``launch = StepLaunchers(ar, cfg)``; ``return launch.monitor, ...``)
  on the other;
- launcher objects: calling a class reaches its ``__init__``, calling an
  instance its ``__call__``, and ``self.<attr>`` resolves through the
  ``self.<attr> = Class(...)`` assignments of the class's methods (so
  ``self._router(st)(t, st)`` reaches ``RouteArrivals.__call__``);
- re-exports: ``ops.MonitorTick`` resolves through ``kernels/ops.py``'s
  ``from ...cong_update import MonitorTick``.

Value lattice: ``STATIC < UNKNOWN < DEVICE``.

- STATIC: host Python values: config dataclasses (``SimConfig``,
  ``ArchConfig``, the ``*Params`` families), literals, shapes and tensor
  metadata (``.shape``, ``.size()``, ``.numel()``, ``.dim()``,
  ``.dtype``, ``.device``, ``.is_cuda``), ``len(...)``, the result of a
  host read (``int(x)``, ``x.item()``; the read itself is flagged), and
  anything derived from only those.
- DEVICE: parameters annotated ``torch.Tensor``, ``SimState``,
  ``PacketState`` or ``SimArrays``, reads of their attributes, items of
  the ``params``/``cache`` dicts, the result of a ``torch.*`` call or of
  a method of a device value, and anything derived from them. Unlike
  the reference's lattice, ``dict`` and the name ``params`` are not
  static: here they hold tensors.
- UNKNOWN: everything the two rules above cannot decide (unannotated
  parameters, ``self``, calls of the repo's own functions).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import (
    Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple,
)

STATIC, UNKNOWN, DEVICE = 0, 1, 2

# parameter annotations that mean "device tensor(s)"
DEVICE_PARAM_TYPES = {"Tensor", "SimState", "PacketState", "SimArrays"}
# parameter annotations that mean "host Python value"
STATIC_PARAM_TYPES = {
    "SimConfig", "ArchConfig", "SelectParams", "PathQParams", "CongParams",
    "ExpSpec", "TrainConfig", "int", "float", "bool", "str", "bytes",
    "tuple", "np.ndarray", "device", "dtype",
}
# parameter names conventionally bound to host config in the port
STATIC_PARAM_NAMES = {"cfg", "config", "mode", "policy", "name", "axis",
                      "seed"}
# dict names whose items are device tensors (model weights, KV caches)
DEVICE_DICT_NAMES = {"params", "cache"}
# tensor attributes that are host metadata
SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad", "itemsize", "nbytes", "is_leaf",
               "is_sparse", "is_meta", "is_quantized"}
# tensor methods that return host metadata without reading the device
META_METHODS = {"dim", "size", "numel", "nelement", "ndimension",
                "is_contiguous", "data_ptr", "get_device", "element_size",
                "stride", "storage_offset", "is_floating_point",
                "is_complex", "is_pinned", "__len__"}
# tensor methods that read a device value back to the host
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch namespaces and calls that return host values
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch._C.", "torch.utils.",
                        "torch.profiler.", "torch.autograd.", "torch.jit.",
                        "torch.compiler.", "torch.testing.")
_TORCH_HOST_CALLS = {
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.is_tensor", "torch.is_floating_point",
    "torch.is_complex", "torch.numel", "torch.get_default_dtype",
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.Generator", "torch.manual_seed",
}

# the port's step bodies, the counterpart of the reference's NAMED_SEEDS
# (``fluid.run_impl``/``packet.run_impl``): ``make_step.step`` of
# ``netsim/fluid.py`` and ``netsim/packet.py``, ``serve/decode.py``'s
# ``decode_step``. Any function with one of these qualified names seeds
# step reachability, so a fixture file can hold one.
STEP_QUALS = ("make_step.step", "decode_step")


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None for
    non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FuncInfo:
    qual: str                       # "outer.inner" / "Class.method"
    path: str                       # repo-relative module path
    node: ast.AST                   # FunctionDef / AsyncFunctionDef
    parent: Optional[str] = None    # enclosing function qual, if nested
    cls: Optional[str] = None       # owning class qual, for a method
    nested: List[str] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.path}::{self.qual}"


@dataclasses.dataclass
class ClassInfo:
    qual: str
    path: str
    node: ast.ClassDef
    methods: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModuleInfo:
    path: str                       # repo-relative, forward slashes
    dotted: str                     # importable dotted name under the root
    tree: ast.Module
    lines: List[str]
    funcs: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    # local name -> ("module", dotted) | ("attr", dotted_module, attr)
    imports: Dict[str, Tuple] = dataclasses.field(default_factory=dict)


# what an expression may denote, for call resolution:
# ("func", FuncInfo) | ("class", ClassInfo) | ("inst", ClassInfo)
Target = Tuple[str, object]


class RepoIndex:
    """Parsed view of every analyzed file plus name-resolution maps."""

    def __init__(self, root: str, files: Sequence[str]) -> None:
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_dotted: Dict[str, ModuleInfo] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self._returns: Dict[str, List[Target]] = {}
        self._ret_class: Dict[str, int] = {}
        self._active: Set[Tuple] = set()
        for path in files:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                tree = ast.parse(src, filename=rel)
            except (SyntaxError, UnicodeDecodeError, OSError):
                continue
            mod = ModuleInfo(path=rel, dotted=_dotted_of(rel), tree=tree,
                             lines=src.splitlines())
            _index_module(mod)
            self.modules[rel] = mod
            self.by_dotted[mod.dotted] = mod
            for fi in mod.funcs.values():
                self.funcs[fi.key] = fi

    # -------------------------------------------------- name resolution
    def targets(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                node: ast.AST) -> List[Target]:
        """What ``node`` may denote: functions, classes, instances."""
        key = ("t", mod.path, scope.qual if scope else None, id(node))
        if key in self._active or len(self._active) > 64:
            return []
        self._active.add(key)
        try:
            return _uniq(self._targets(mod, scope, node))
        finally:
            self._active.discard(key)

    def _targets(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                 node: ast.AST) -> List[Target]:
        if isinstance(node, ast.Name):
            return self._name_targets(mod, scope, node.id)
        if isinstance(node, ast.Attribute):
            return self._attr_targets(mod, scope, node)
        if isinstance(node, ast.Call):
            out: List[Target] = []
            for kind, obj in self.targets(mod, scope, node.func):
                if kind == "class":
                    out.append(("inst", obj))
                elif kind == "func":
                    out.extend(self.returns(obj))
                elif kind == "inst" and "__call__" in obj.methods:
                    out.extend(self.returns(obj.methods["__call__"]))
            return out
        if isinstance(node, ast.IfExp):
            return (self.targets(mod, scope, node.body)
                    + self.targets(mod, scope, node.orelse))
        if isinstance(node, ast.BoolOp):
            return [t for v in node.values
                    for t in self.targets(mod, scope, v)]
        return []

    def _name_targets(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                      name: str) -> List[Target]:
        fi = self._resolve_name(mod, scope, name)
        if fi is not None:
            return [("func", fi)]
        s = scope
        while s is not None:
            if _is_self(s, name):
                cls = _class_of(mod, s)
                return [("inst", cls)] if cls else []
            if name in param_names(s.node):
                return []
            bound = self._bound_in(mod, s, name)
            if bound is not None:
                return bound
            s = mod.funcs.get(s.parent) if s.parent else None
        if name in mod.classes:
            return [("class", mod.classes[name])]
        imp = mod.imports.get(name)
        if imp and imp[0] == "attr":
            return self._member(imp[1], imp[2])
        return []

    def _bound_in(self, mod: ModuleInfo, scope: FuncInfo,
                  name: str) -> Optional[List[Target]]:
        """Targets of the assignments binding ``name`` in ``scope``'s own
        body; None when the body does not bind it."""
        out: List[Target] = []
        found = False
        for stmt in _own_nodes(scope, mod):
            if not isinstance(stmt, ast.Assign):
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    found = True
                    out.extend(self.targets(mod, scope, stmt.value))
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    for i, elt in enumerate(tgt.elts):
                        if isinstance(elt, ast.Name) and elt.id == name:
                            found = True
                            out.extend(self.item_targets(mod, scope,
                                                         stmt.value, i))
        return out if found else None

    def item_targets(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                     node: ast.AST, i: int) -> List[Target]:
        """Targets of item ``i`` of a tuple-valued expression."""
        if isinstance(node, (ast.Tuple, ast.List)):
            return (self.targets(mod, scope, node.elts[i])
                    if i < len(node.elts) else [])
        out: List[Target] = []
        if isinstance(node, ast.Call):
            for kind, fi in self.targets(mod, scope, node.func):
                if kind != "func":
                    continue
                fmod = self.modules[fi.path]
                for ret in _own_returns(fi, fmod):
                    out.extend(self.item_targets(fmod, fi, ret, i))
        return out

    def _attr_targets(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                      node: ast.Attribute) -> List[Target]:
        base = node.value
        if isinstance(base, ast.Name) and not (
                scope is not None and self._shadowed(mod, scope, base.id)):
            imp = mod.imports.get(base.id)
            if imp and imp[0] == "module":
                return self._member(imp[1], node.attr)
            if imp and imp[0] == "attr":
                # `from repro_torch.kernels import ops; ops.MonitorTick`
                return self._member(f"{imp[1]}.{imp[2]}", node.attr)
        out: List[Target] = []
        for kind, obj in self.targets(mod, scope, base):
            if kind in ("inst", "class"):
                out.extend(self._class_attr(obj, node.attr))
        return out

    def _shadowed(self, mod: ModuleInfo, scope: FuncInfo, name: str) -> bool:
        s: Optional[FuncInfo] = scope
        while s is not None:
            if name in param_names(s.node):
                return True
            s = mod.funcs.get(s.parent) if s.parent else None
        return False

    def _class_attr(self, cls: ClassInfo, attr: str) -> List[Target]:
        """A method (bound), or what ``self.<attr> = ...`` assigns."""
        if attr in cls.methods:
            return [("func", cls.methods[attr])]
        cmod = self.modules[cls.path]
        out: List[Target] = []
        for meth in cls.methods.values():
            for stmt in _own_nodes(meth, cmod):
                if not isinstance(stmt, ast.Assign):
                    continue
                for tgt in stmt.targets:
                    if (isinstance(tgt, ast.Attribute) and tgt.attr == attr
                            and isinstance(tgt.value, ast.Name)
                            and _is_self(meth, tgt.value.id)):
                        out.extend(self.targets(cmod, meth, stmt.value))
        return out

    def returns(self, fi: FuncInfo) -> List[Target]:
        """Targets of what ``fi`` returns."""
        if fi.key in self._returns:
            return self._returns[fi.key]
        self._returns[fi.key] = []        # recursion guard
        fmod = self.modules[fi.path]
        out: List[Target] = []
        for ret in _own_returns(fi, fmod):
            out.extend(self.targets(fmod, fi, ret))
        self._returns[fi.key] = _uniq(out)
        return self._returns[fi.key]

    def return_class(self, fi: FuncInfo) -> int:
        """The lattice class of what ``fi`` returns: its return
        annotation's, else the join of its return expressions' classes
        at the end of its body (``return st`` of a ``st: SimState``)."""
        if fi.key in self._ret_class:
            return self._ret_class[fi.key]
        cls = annotation_class(getattr(fi.node, "returns", None))
        if cls == UNKNOWN and isinstance(fi.node, (ast.FunctionDef,
                                                   ast.AsyncFunctionDef)):
            self._ret_class[fi.key] = UNKNOWN      # recursion guard
            mod = self.modules[fi.path]
            flow = ValueFlow(mod, fi, None, self)
            flow.run()
            rets = _own_returns(fi, mod)
            cls = join(*[flow.expr(r) for r in rets]) if rets else UNKNOWN
        self._ret_class[fi.key] = cls
        return cls

    def _resolve_name(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                      name: str) -> Optional[FuncInfo]:
        """Nested defs of the scope chain first, then module level."""
        s = scope
        while s is not None:
            cand = f"{s.qual}.{name}"
            if cand in mod.funcs:
                return mod.funcs[cand]
            s = mod.funcs.get(s.parent) if s.parent else None
        return mod.funcs.get(name)

    def _member(self, dotted: str, attr: str, depth: int = 0
                ) -> List[Target]:
        """Module member ``attr`` of ``dotted``, following re-exports."""
        target = self.by_dotted.get(dotted)
        if target is None or depth > 4:
            return []
        if attr in target.funcs:
            return [("func", target.funcs[attr])]
        if attr in target.classes:
            return [("class", target.classes[attr])]
        imp = target.imports.get(attr)
        if imp and imp[0] == "attr":
            return self._member(imp[1], imp[2], depth + 1)
        return []

    def callees(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                func: ast.AST) -> List[FuncInfo]:
        """Functions a call of ``func`` runs: a function, a class's
        ``__init__``, an instance's ``__call__``."""
        out: List[FuncInfo] = []
        for kind, obj in self.targets(mod, scope, func):
            if kind == "func":
                out.append(obj)
            elif kind == "class" and "__init__" in obj.methods:
                out.append(obj.methods["__init__"])
            elif kind == "inst" and "__call__" in obj.methods:
                out.append(obj.methods["__call__"])
        return out

    # -------------------------------------------------- reachability
    def step_seeds(self) -> Set[str]:
        """Keys of the step bodies (``STEP_QUALS``)."""
        return {fi.key for fi in self.funcs.values()
                if fi.qual in STEP_QUALS}

    def reachable(self, seeds: Iterable[str]) -> Set[str]:
        """Transitive closure over call edges, functions passed as call
        arguments, and nested-def containment."""
        out: Set[str] = set()
        work = [k for k in seeds if k in self.funcs]
        while work:
            key = work.pop()
            if key in out:
                continue
            out.add(key)
            fi = self.funcs[key]
            mod = self.modules[fi.path]
            for n in fi.nested:
                nk = f"{fi.path}::{fi.qual}.{n}"
                if nk in self.funcs and nk not in out:
                    work.append(nk)
            for call in _iter_calls_in(fi, mod):
                found = list(self.callees(mod, fi, call.func))
                for arg in list(call.args) + [kw.value
                                              for kw in call.keywords]:
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        found.extend(o for k, o in self.targets(mod, fi, arg)
                                     if k == "func")
                for callee in found:
                    if callee.key not in out:
                        work.append(callee.key)
        return out

    def step_reachable(self) -> Set[str]:
        return self.reachable(self.step_seeds())


@dataclasses.dataclass
class CheckContext:
    """Everything a checker gets: the repo root, the parsed index, and
    an optional wire-manifest path override."""
    root: str
    index: RepoIndex
    manifest_path: Optional[str] = None


def _uniq(targets: List[Target]) -> List[Target]:
    seen: Set[Tuple[str, int]] = set()
    out: List[Target] = []
    for kind, obj in targets:
        k = (kind, id(obj))
        if k not in seen:
            seen.add(k)
            out.append((kind, obj))
    return out


def param_names(node: ast.AST) -> Set[str]:
    """The parameter names of a function node."""
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return set(names)


def _is_self(fi: FuncInfo, name: str) -> bool:
    """Whether ``name`` is the first parameter of method ``fi``."""
    if fi.cls is None or not isinstance(fi.node, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef)):
        return False
    pos = fi.node.args.posonlyargs + fi.node.args.args
    return bool(pos) and pos[0].arg == name and not any(
        isinstance(d, ast.Name) and d.id == "staticmethod"
        for d in fi.node.decorator_list)


def _class_of(mod: ModuleInfo, fi: FuncInfo) -> Optional[ClassInfo]:
    return mod.classes.get(fi.cls) if fi.cls else None


def _dotted_of(rel: str) -> str:
    p = rel[:-3] if rel.endswith(".py") else rel
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    if p.startswith("src/"):
        p = p[4:]
    return p.replace("/", ".")


def _index_module(mod: ModuleInfo) -> None:
    """Collect function and class defs (with nesting), returns-nested,
    imports."""

    def walk(node: ast.AST, parent: Optional[FuncInfo],
             cls: Optional[ClassInfo]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{parent.qual}.{child.name}" if parent
                        else child.name)
                fi = FuncInfo(qual=qual, path=mod.path, node=child,
                              parent=(parent.qual if parent and cls is None
                                      else None),
                              cls=cls.qual if cls else None)
                mod.funcs[qual] = fi
                if cls is not None:
                    cls.methods[child.name] = fi
                elif parent is not None:
                    parent.nested.append(child.name)
                walk(child, fi, None)
            elif isinstance(child, ast.ClassDef):
                # methods index under "Class.method"; a class nested in a
                # function keeps the enclosing qual prefix
                qual = (f"{parent.qual}.{child.name}" if parent
                        else child.name)
                ci = ClassInfo(qual=qual, path=mod.path, node=child)
                mod.classes[qual] = ci
                fake = FuncInfo(qual=qual, path=mod.path, node=child)
                walk(child, fake, ci)
            else:
                walk(child, parent, cls)

    walk(mod.tree, None, None)

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mod.imports[a.asname] = ("module", a.name)
                else:
                    root = a.name.split(".")[0]
                    mod.imports[root] = ("module", root)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            for a in node.names:
                # may denote a function (`from engine import decide`) or
                # a submodule (`from repro_torch.netsim import engine`):
                # the RepoIndex lookup tries both interpretations
                mod.imports[a.asname or a.name] = (
                    "attr", node.module, a.name)


def _nested_spans(fi: FuncInfo, mod: ModuleInfo) -> List[Tuple[int, int]]:
    spans = []
    for n in fi.nested:
        nf = mod.funcs.get(f"{fi.qual}.{n}")
        if nf is not None:
            spans.append((nf.node.lineno,
                          getattr(nf.node, "end_lineno", nf.node.lineno)))
    return spans


def _own_nodes(fi: FuncInfo, mod: ModuleInfo) -> Iterator[ast.AST]:
    """Nodes of ``fi``'s own body (nested defs excluded)."""
    spans = _nested_spans(fi, mod)
    for node in ast.walk(fi.node):
        ln = getattr(node, "lineno", None)
        if ln is not None and node is not fi.node and \
                any(a <= ln <= b for a, b in spans):
            continue
        yield node


def _own_returns(fi: FuncInfo, mod: ModuleInfo) -> List[ast.expr]:
    return [n.value for n in _own_nodes(fi, mod)
            if isinstance(n, ast.Return) and n.value is not None]


def _iter_calls_in(fi: FuncInfo, mod: ModuleInfo) -> Iterator[ast.Call]:
    """Call nodes belonging to ``fi``'s own body (nested defs excluded:
    they are separate FuncInfos with their own edges)."""
    for node in _own_nodes(fi, mod):
        if isinstance(node, ast.Call):
            yield node


def canonical(mod: ModuleInfo, dotted: Optional[str]) -> Optional[str]:
    """A dotted call name with its import alias expanded
    (``F.silu`` -> ``torch.nn.functional.silu``)."""
    if dotted is None:
        return None
    root, _, rest = dotted.partition(".")
    imp = mod.imports.get(root)
    if imp is None:
        return dotted
    full = imp[1] if imp[0] == "module" else f"{imp[1]}.{imp[2]}"
    return f"{full}.{rest}" if rest else full


# ------------------------------------------------------------- dataflow
def join(*vals: int) -> int:
    return max(vals) if vals else STATIC


def annotation_class(ann: Optional[ast.AST]) -> int:
    """DEVICE or STATIC for an annotation naming only device or only
    host types (``Optional[int]`` is STATIC), else UNKNOWN."""
    names = set()
    for n in ast.walk(ann) if ann is not None else ():
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
            if isinstance(n.value, ast.Name) and \
                    n.value.id in ("np", "numpy"):
                names.add("np.ndarray")
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            names.add(n.value)
    dev = bool(names & DEVICE_PARAM_TYPES)
    host = bool(names & STATIC_PARAM_TYPES)
    if dev != host:
        return DEVICE if dev else STATIC
    return UNKNOWN


class ValueFlow:
    """One-function forward dataflow over the STATIC/UNKNOWN/DEVICE
    lattice. Checkers subclass and override the ``on_*`` hooks, which
    fire during the statement walk with the environment live. The
    statement walk is the reference linter's, so the unit checker that
    rides on it sees the same statements."""

    def __init__(self, mod: ModuleInfo, fi: FuncInfo,
                 init_env: Optional[Dict[str, int]] = None,
                 index: Optional[RepoIndex] = None) -> None:
        self.mod = mod
        self.fi = fi
        self.index = index
        self.env: Dict[str, int] = dict(init_env or {})
        self._classify_params()

    # ------------------------------------------------------------ hooks
    def on_call(self, node: ast.Call, arg_classes: List[int],
                recv_class: Optional[int]) -> None:
        """``recv_class``: the receiver's class for a method call (or a
        module function's, STATIC), else None."""

    def on_branch(self, node: ast.AST, test_class: int) -> None:
        pass

    def on_subscript(self, node: ast.Subscript, value_class: int,
                     index_class: int) -> None:
        pass

    def on_bind(self, name: str, value: Optional[ast.expr]) -> None:
        pass

    # ------------------------------------------------------- main entry
    def run(self) -> Dict[str, int]:
        body = getattr(self.fi.node, "body", [])
        # two passes: loop-carried names settle on the second
        for _ in range(2):
            for stmt in body:
                self._stmt(stmt)
        return self.env

    # ---------------------------------------------------------- helpers
    def _classify_params(self) -> None:
        node = self.fi.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        args = node.args
        # params with a literal default (None/True/False/0/"s") are
        # host flags in this codebase, not tensors
        has_const_default: Dict[str, bool] = {}
        pos = list(args.posonlyargs) + list(args.args)
        for a, d in zip(reversed(pos), reversed(args.defaults)):
            has_const_default[a.arg] = isinstance(d, ast.Constant)
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if d is not None:
                has_const_default[a.arg] = isinstance(d, ast.Constant)
        for a in (pos + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            cls = annotation_class(a.annotation)
            if cls == UNKNOWN and (a.arg in STATIC_PARAM_NAMES
                                   or has_const_default.get(a.arg)):
                cls = STATIC
            self.env[a.arg] = cls

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            self.env[stmt.name] = STATIC     # the function object itself
            return                           # body analyzed separately
        if isinstance(stmt, ast.Assign):
            cls = self.expr(stmt.value)
            for tgt in stmt.targets:
                self._bind(tgt, cls, stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            cls = self.expr(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self.env[stmt.target.id] = join(
                    self.env.get(stmt.target.id, STATIC), cls)
            else:
                self.expr(stmt.target)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.expr(stmt.value), stmt.value)
        elif isinstance(stmt, (ast.If, ast.While)):
            tc = self.expr(stmt.test)
            self.on_branch(stmt, tc)
            before = dict(self.env)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
            # either branch may have run: a name keeps its higher class
            for name, cls in before.items():
                self.env[name] = join(cls, self.env.get(name, cls))
        elif isinstance(stmt, ast.For):
            it = self.expr(stmt.iter)
            self._bind(stmt.target, self._iter_elem_class(stmt.iter, it),
                       None)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.expr(item.context_expr)
            for s in stmt.body:
                self._stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in (stmt.body + stmt.orelse + stmt.finalbody
                      + [h for hh in stmt.handlers for h in hh.body]):
                self._stmt(s)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.expr(stmt.value)
        elif isinstance(stmt, ast.Expr):
            self.expr(stmt.value)
        elif isinstance(stmt, ast.Assert):
            self.on_branch(stmt, self.expr(stmt.test))
            if stmt.msg is not None:
                self.expr(stmt.msg)
        elif isinstance(stmt, ast.Raise):
            for v in ast.iter_child_nodes(stmt):
                if isinstance(v, ast.expr):
                    self.expr(v)

    def _bind(self, target: ast.expr, cls: int,
              value: Optional[ast.expr]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = cls
            self.on_bind(target.id, value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, cls, None)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, cls, None)
        else:
            # attribute/subscript targets: no env effect, but their
            # index expressions are evaluated
            self.expr(target)

    def _iter_elem_class(self, iter_node: ast.expr, iter_cls: int) -> int:
        d = dotted_name(iter_node.func) if isinstance(iter_node, ast.Call) \
            else None
        if d in ("range", "enumerate", "zip"):
            if isinstance(iter_node, ast.Call):
                return join(*[self.expr(a) for a in iter_node.args]) \
                    if iter_node.args else STATIC
        return iter_cls

    # ------------------------------------------------- expression rules
    def expr(self, node: ast.expr) -> int:
        if isinstance(node, ast.Constant):
            return STATIC
        if isinstance(node, ast.Name):
            return self.env.get(node.id, STATIC)   # globals/consts: static
        if isinstance(node, ast.Attribute):
            if node.attr in SHAPE_ATTRS:
                self.expr(node.value)
                return STATIC
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            vc = self.expr(node.value)
            ic = self.expr(node.slice)
            self.on_subscript(node, vc, ic)
            if isinstance(node.value, ast.Name) and \
                    node.value.id in DEVICE_DICT_NAMES:
                return DEVICE
            return join(vc, ic)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            return join(self.expr(node.left), self.expr(node.right))
        if isinstance(node, ast.UnaryOp):
            c = self.expr(node.operand)
            if isinstance(node.op, ast.Not):
                self.on_branch(node, c)      # `not x` calls bool(x)
                return STATIC
            return c
        if isinstance(node, ast.BoolOp):
            classes = [self.expr(v) for v in node.values]
            # every operand but the last is passed through bool()
            self.on_branch(node, join(*classes[:-1]))
            return join(*classes)
        if isinstance(node, ast.Compare):
            classes = [self.expr(node.left)] + [self.expr(c)
                                                for c in node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return STATIC              # identity: no tensor op
            return join(*classes)
        if isinstance(node, ast.IfExp):
            tc = self.expr(node.test)
            self.on_branch(node, tc)
            return join(tc, self.expr(node.body), self.expr(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return join(*[self.expr(e) for e in node.elts]) \
                if node.elts else STATIC
        if isinstance(node, ast.Dict):
            vals = [v for v in list(node.keys) + list(node.values)
                    if v is not None]
            return join(*[self.expr(v) for v in vals]) if vals else STATIC
        if isinstance(node, ast.Slice):
            parts = [p for p in (node.lower, node.upper, node.step)
                     if p is not None]
            return join(*[self.expr(p) for p in parts]) if parts else STATIC
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self.expr(gen.iter)
            return UNKNOWN
        if isinstance(node, ast.Lambda):
            return STATIC
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        if isinstance(node, ast.JoinedStr):
            return STATIC
        if isinstance(node, ast.FormattedValue):
            self.expr(node.value)
            return STATIC
        if isinstance(node, ast.NamedExpr):
            cls = self.expr(node.value)
            self._bind(node.target, cls, node.value)
            return cls
        return UNKNOWN

    def _call(self, node: ast.Call) -> int:
        arg_classes = [self.expr(a) for a in node.args]
        kw_classes = [self.expr(kw.value) for kw in node.keywords]
        rc = self.expr(node.func.value) \
            if isinstance(node.func, ast.Attribute) else None
        self.on_call(node, arg_classes, rc)
        allc = arg_classes + kw_classes
        d = self.call_name(node)
        if d is not None and d.startswith("torch."):
            return self._torch_call(d)
        if d is not None and d.split(".", 1)[0] in ("numpy", "math"):
            return join(*allc) if allc else STATIC
        if d in ("replace", "dataclasses.replace") and arg_classes:
            return arg_classes[0]             # the same state, new fields
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id in self.mod.imports \
                    and recv.id not in self.env:
                return self._returned(node)   # a module's function
            meth = node.func.attr
            if meth in META_METHODS or meth in HOST_READ_METHODS:
                return STATIC
            if rc == DEVICE:
                return DEVICE                 # a tensor method's result
            if rc == STATIC:
                return join(*allc) if allc else STATIC
            return self._returned(node)
        if d is None:
            return self._returned(node)
        if d in ("len", "float", "int", "bool", "str", "repr", "isinstance",
                 "hasattr", "callable", "id", "type"):
            return STATIC                     # host values (reads flagged)
        if d in ("abs", "max", "min", "round", "sum", "range", "tuple",
                 "list", "dict", "sorted", "enumerate", "zip", "divmod",
                 "pow", "getattr"):
            return join(*allc) if allc else STATIC
        return self._returned(node)

    def _returned(self, node: ast.Call) -> int:
        """The class of what the repo functions a call runs return
        (``RepoIndex.return_class``; DEVICE if any callee's is),
        UNKNOWN where none resolves."""
        if self.index is None:
            return UNKNOWN
        classes = [self.index.return_class(fi)
                   for fi in self.index.callees(self.mod, self.fi,
                                                node.func)]
        if DEVICE in classes:
            return DEVICE
        return STATIC if classes and set(classes) == {STATIC} else UNKNOWN

    def call_name(self, node: ast.Call) -> Optional[str]:
        """The call's dotted name with a module alias expanded
        (``F.silu`` -> ``torch.nn.functional.silu``); a local variable
        that shadows an import is left as it is."""
        d = dotted_name(node.func)
        if d is None or d.split(".", 1)[0] in self.env:
            return d
        return canonical(self.mod, d)

    @staticmethod
    def _torch_call(d: str) -> int:
        if d in _TORCH_HOST_CALLS or d.startswith(_TORCH_HOST_PREFIXES):
            return STATIC
        return DEVICE

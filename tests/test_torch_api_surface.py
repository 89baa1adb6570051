"""The port's public surface against the reference's, module by module.

Every public name of ``src/repro/**/*.py`` must exist in the matching
module of ``src/repro_torch/`` (paired by path; the reference's
``analysis/tracing.py`` pairs with the port's ``analysis/syncs.py``), or
stand in ``BY_DESIGN`` with the reason the port has no counterpart. A
name is public when the module defines it at top level (``def``,
``class``, an assignment) and it does not start with ``_``, or when the
module's ``__all__`` lists it; an imported name counts only through
``__all__``. In the port any top-level binding counts, re-exports
included. A ``BY_DESIGN`` entry that the port has after all, or that is
not a public name of the reference, fails the test, so the list cannot
go stale. Pure ``ast``: nothing of either package is imported.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
RENAMED = {"analysis/tracing.py": "analysis/syncs.py"}

# reference module -> {public name: why the port has no counterpart}
BY_DESIGN = {
    "analysis/astutil.py": {
        "TRACED": "the top of the JAX tracing lattice; the port's lint "
                  "tracks host syncs (analysis/syncs.py), not tracers"},
    "analysis/tracing.py": {
        "check_tracing": "the JAX tracer-leak family; replaced by "
                         "analysis/syncs.py's host-sync checks (DEV001-DEV004)",
        "NAMED_SEEDS": "the jit and scan bodies the tracer walk starts from; "
                       "syncs.py starts from the engine and decode steps"},
    "core/baselines.py": {
        "RedTEState": "RedTE is carried by engine.redte_tick, held against "
                      "the reference's by tests/test_torch_policies.py",
        "redte": "as RedTEState",
        "redte_update": "as RedTEState"},
    "kernels/cong_update.py": {
        "BP": "the Pallas block's ports; the CUDA kernel's block is its "
              "launch configuration (csrc/cong_update.cu)"},
    "kernels/lcmp_decide.py": {
        "BF": "the Pallas block's flows (lane width); a CUDA launch "
              "configuration here",
        "P_PAD": "the Pallas candidate axis padded to 8; the CUDA kernels "
                 "take up to 8 candidates unpadded"},
    "models/arch.py": {
        "SCAN_UNROLL": "the lax.scan unroll flag of the layer stack; the "
                       "port loops over layers in Python"},
    "models/layers.py": {
        "MOE_CAPACITY_AXIS": "a jit sharding-constraint axis; the port pins "
                             "DTensor layouts in dist/mesh_rules.py"},
    "netsim/engine.py": {
        "RING_SCATTER_MODE": "the XLA scatter mode of the ring writes; "
                             "torch's indexed writes take no mode",
        "STATE_PAD": "per-flow pad values for padded sweep cells; "
                     "merge_cells concatenates cells and pads nothing"},
    "netsim/fluid.py": {
        "run_impl": "the unjitted scan body the reference's sweep vmaps; "
                    "run is a host loop and sweeps merge cells"},
    "netsim/packet.py": {
        "run_impl": "as fluid.run_impl"},
    "netsim/sanitize.py": {
        "run_with_checks": "checkify's wrapper; the port's checks run in "
                           "the step (Checker) and raise at run's end",
        "checked_call": "as run_with_checks"},
    "netsim/sweep.py": {
        "CellArrays": "the vmapped cell axis of a chunk; the port merges a "
                      "group into one world (engine.merge_cells)"},
}

MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _module_level(body):
    """The module's statements, with those of top-level ``if``/``try``
    blocks (still module scope)."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _module_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _module_level(node.body + node.orelse + node.finalbody
                                     + [s for h in node.handlers for s in h.body])


def _targets(node):
    targets = (node.targets if isinstance(node, ast.Assign) else [node.target])
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _all(tree: ast.Module) -> set:
    names = set()
    for node in _module_level(tree.body):
        if (isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign))
                and "__all__" in _targets(node)):
            names |= set(ast.literal_eval(node.value))
    return names


def _defined(tree: ast.Module) -> set:
    names = set()
    for node in _module_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            names |= set(_targets(node))
    return names


def _imported(tree: ast.Module) -> set:
    return {(a.asname or a.name).split(".")[0]
            for node in _module_level(tree.body)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in node.names}


def reference_public(tree: ast.Module) -> set:
    return {n for n in _defined(tree) if not n.startswith("_")} | _all(tree)


def port_names(tree: ast.Module) -> set:
    return _defined(tree) | _imported(tree) | _all(tree)


@pytest.mark.parametrize("module", MODULES)
def test_reference_names_have_counterparts(module):
    ref = reference_public(_parse(REF / module))
    port_path = PORT / RENAMED.get(module, module)
    assert port_path.exists(), f"no port module for {module}"
    have = port_names(_parse(port_path))
    excused = BY_DESIGN.get(module, {})
    missing = sorted(ref - have - set(excused))
    assert not missing, f"{module}: no counterpart in the port: {missing}"
    stale = sorted(set(excused) & have)
    assert not stale, f"{module}: BY_DESIGN names the port has: {stale}"
    unknown = sorted(set(excused) - ref)
    assert not unknown, f"{module}: BY_DESIGN names no public name: {unknown}"


def test_by_design_names_reference_modules_with_reasons():
    assert set(BY_DESIGN) <= set(MODULES)
    assert all(isinstance(why, str) and why for names in BY_DESIGN.values()
               for why in names.values())


def test_the_surface_rule():
    """Imports count in the reference only through ``__all__``; in the
    port any binding counts."""
    tree = ast.parse("from m import a, b as c\nimport x.y\n__all__ = ['a']\n"
                     "def f(): pass\n_g = 1\nclass K: pass\n"
                     "if True:\n    h = 2\n")
    assert reference_public(tree) == {"a", "f", "K", "h"}
    assert port_names(tree) == {"a", "c", "x", "__all__", "f", "_g", "K",
                                "h"}

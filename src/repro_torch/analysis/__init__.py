"""``reprolint`` for the port: repo-specific static analysis of
``repro_torch``, the counterpart of the reference's ``repro.analysis``.

It imports neither JAX nor ``repro``: every helper it needs is its own
copy. It runs over the port's files (``src/repro_torch`` and the port's
tests) and machine-checks on every commit:

- ``syncs``      (DEV001-DEV004): host reads (``.item()``, ``.cpu()``,
  ``int()`` of a tensor), Python control flow on device values,
  accumulating scatters into an accumulator of unstated dtype, and
  data-dependent shapes or host builds (``nonzero``, ``unique``,
  boolean masks, ``torch.tensor`` of host data), inside
  *step-reachable* code: the engine steps (``make_step.step`` of
  ``netsim/fluid.py`` and ``netsim/packet.py``) and ``decode_step``,
  through the launchers they build and call. Steps after the first
  must make no host sync, so queue B's CUDA graphs can capture them.
- ``axes``       (AXS001-AXS003): every ``ExpSpec`` field declared
  static, dynamic or exempt in the ``AXES_*`` tables, consistent with
  how ``spec_to_cfg`` reads it.
- ``wire``       (WIR001-WIR002): ``manifest.json`` freezes the port's
  ``POLICY_CODES``, ``REDECIDE_POLICIES``, ``scenarios.names()``,
  ``sched.FAMILIES`` and this catalog's codes.
- ``rings``      (RNG001-RNG002): every history-ring subscript wraps
  with ``% HIST``, and the build-time ring-capacity guard stays.
- ``units``      (UNI001-UNI004): the ``*_us``/``*_bytes``/... naming
  convention's dimensions.
- ``invariants`` (INV001-INV002): every state field the step mutates
  (returned or written in place) has a sanitizer invariant or an
  exemption.

Run ``PYTHONPATH=src python -m repro_torch.analysis``
(``--format=text|json|github``); see ``docs/torch_static_analysis.md``
for the catalog, the ``# reprolint: ignore[CODE] why`` exemption syntax
(shared with the reference linter) and what an AST check cannot see.
"""
from __future__ import annotations

from repro_torch.analysis.findings import CODES, Finding
from repro_torch.analysis.runner import CHECKS, run_checks

__all__ = ["CODES", "CHECKS", "Finding", "run_checks"]

"""Debug-mode physics-invariant sanitizer for both engines (counterpart
of ``repro/netsim/sanitize.py``).

Every headline number rests on the engines being physically right:
bytes conserved, queues non-negative and lossless, congestion signals
never fresher than backward propagation, PFC pauses honored. The same
ten ``INVARIANTS`` as the reference's, with its thresholds, are held
here at every step of either engine when ``SimConfig.checks`` is set
(``ExpSpec(checks=1)`` or ``REPRO_CHECKS=1``).

The reference threads ``checkify`` through its jitted scan. The port
has no checkify, so its design is its own:

- each check yields ``(ok, message)``, ``ok`` a 0-d device bool; a
  run's ``Checker`` stacks one step's checks and keeps, per check slot,
  the first step at which it failed, in one small int32 tensor updated
  with ``torch.where``. Nothing syncs in the step;
- one read at the end of the run (``Checker.throw``, which
  ``fluid.run`` and ``packet.run`` call, so a sweep group's merged run
  is held too) raises ``InvariantError`` with the reference's message of
  the first failure in checkify's order: the earliest step, and within
  a step the packet hop loop's inline ``pfc_lossless`` checks
  (``check_pfc``) first, then ``INVARIANTS`` in order.

With checks off the engines never call into this module: their step
adds no op and no sync. The reference's ``_checked_runner``,
``run_with_checks`` and ``checked_call`` (checkify under ``jit``) have no
counterpart: ``run`` itself throws.

Three registries tie the module to the reference's static analyzer:
``INVARIANTS`` (name -> per-step check), ``INVARIANT_COVERAGE`` (state
field -> the invariants that constrain it) and ``COVERAGE_EXEMPT``
(field -> why no runtime check applies), copied from the reference.
``_MUTATION`` is the test seam: a ``(t, state) -> state`` corruptor
applied before the checks, whose new state flows onward through the run
like a real physics bug (a mutation returns new tensors: the step
updates some of the state's tensors in place).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.netsim.engine import HIST, SimArrays, SimConfig

# test seam: (t, state) -> corrupted state, applied before the checks
_MUTATION: Optional[Callable[[Any, Any], Any]] = None

# relative slack for f32 accumulation (per-flow byte accounting crosses
# thousands of rounded adds on ~MB quantities)
_REL_EPS = 1e-3

_NOT_YET = (1 << 31) - 1     # a check slot that has not failed


class InvariantError(RuntimeError):
    """An invariant failed: ``str(e)`` is the reference's message of the
    first failure; ``invariant`` names it and ``step`` is where it
    first failed."""

    def __init__(self, message: str, step: int):
        super().__init__(message)
        self.invariant = message.split(":", 1)[0]
        self.step = step


def enabled(cfg: SimConfig) -> bool:
    """Whether this configuration wants the checked step."""
    return bool(cfg.checks)


def host_checks_enabled() -> bool:
    """Gate of the host-side (numpy) accounting checks in ``metrics`` and
    ``cosim.iterate``: env-only, they run outside any step."""
    return os.environ.get("REPRO_CHECKS") == "1"


def host_check(ok: bool, msg: str) -> None:
    """A failed host-side check raises ``AssertionError``."""
    if not ok:
        raise AssertionError(f"sanitize: {msg}")


Checks = Iterator[Tuple[torch.Tensor, str]]


# ------------------------------------------------------------ invariants
def _check_queue_nonneg(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """Link queues and served-byte counters never go negative."""
    yield ((st.q_bytes >= -1e-3).all(),
           "queue_nonneg: negative link queue bytes")
    yield ((st.serv_bytes >= -1e-3).all(),
           "queue_nonneg: negative served-bytes counter")
    if hasattr(st, "fq"):
        yield ((st.fq >= -1e-3).all(),
               "queue_nonneg: negative per-hop flow queue")


def _check_buffer_bound(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """Lossless RDMA: queue depth never exceeds the (scaled) buffer, up
    to f32 rounding and one packet of quantization."""
    buf = float(cfg.buffer_bytes * cfg.cap_scale)
    slack = 1e-4 * buf + 2.0 * float(cfg.mtu_bytes)
    yield ((st.q_bytes <= buf + slack).all(),
           "buffer_bound: link queue exceeds the lossless buffer")


def _check_byte_conservation(t: int, st, ar: SimArrays,
                             cfg: SimConfig) -> Checks:
    """Per routed flow, bytes are conserved. Fluid: remaining only moves
    from f_size toward 0. Packet: remaining + queued + delivered ==
    f_size (go-back-N returns stranded bytes to ``remaining``)."""
    routed = st.flow_path >= 0
    if hasattr(st, "fq"):
        total = st.remaining + st.fq.sum(-1) + st.delivered
        slack = _REL_EPS * ar.f_size + 2.0 * float(cfg.mtu_bytes)
        ok = (total - ar.f_size).abs() <= slack
    else:
        slack = _REL_EPS * ar.f_size + 1.0
        ok = (st.remaining >= -1e-3) & (st.remaining <= ar.f_size + slack)
    yield (torch.where(routed, ok, True).all(),
           "byte_conservation: flow byte accounting broken")


def _check_ring_head(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """The history rings' slot ``t`` holds exactly this step's state."""
    slot = t % HIST
    yield ((st.hist_q[:, slot] == st.q_bytes).all(),
           "ring_head: hist_q slot t != q_bytes (ring slot skew)")
    yield ((st.hist_c[:, slot] == st.c_cong).all(),
           "ring_head: hist_c slot t != c_cong (ring slot skew)")
    if hasattr(st, "hist_pause"):
        yield ((st.hist_pause[:, slot] == st.pfc_pause).all(),
               "ring_head: hist_pause slot t != pfc_pause")


def _check_clock_monotone(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """Routing and decision timestamps never sit in the future; RTTs are
    at least one step."""
    routed = st.flow_path >= 0
    yield (torch.where(routed, st.route_step <= t, True).all(),
           "clock_monotone: route_step in the future")
    yield ((st.last_dec <= t).all(),
           "clock_monotone: last CC decrease in the future")
    yield ((st.rtt_steps >= 1).all(), "clock_monotone: rtt_steps < 1")
    if hasattr(st, "last_tx"):
        from repro_torch.netsim.packet import _NEVER_SENT
        yield (((st.last_tx <= t) | (st.last_tx == _NEVER_SENT)).all(),
               "clock_monotone: last_tx in the future")


def _check_signal_causality(t: int, st, ar: SimArrays,
                            cfg: SimConfig) -> Checks:
    """Signal staleness offsets are non-negative (reads are never fresher
    than backward propagation, paper §3) and inside the ring."""
    yield ((ar.path_sig_delay >= 0).all(),
           "signal_causality: negative signal delay would read "
           "future congestion")
    yield ((ar.path_sig_delay < HIST).all(),
           "signal_causality: signal delay outruns the ring")


def _check_cc_rate_bounds(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """Active flows send at a positive rate bounded by line rate, the
    DCTCP EWMA stays a probability, targets stay within line rate."""
    line_max = ar.path_cap.max() * 1.001
    act = st.active
    yield (torch.where(act, (st.rate > 0.0) & (st.rate <= line_max),
                       True).all(),
           "cc_rate_bounds: active flow rate outside (0, line]")
    yield (torch.where(act, (st.cc_target >= 0.0)
                       & (st.cc_target <= line_max), True).all(),
           "cc_rate_bounds: CC target outside [0, line]")
    yield (((st.cc_alpha >= 0.0) & (st.cc_alpha <= 1.0)).all(),
           "cc_rate_bounds: DCTCP alpha outside [0, 1]")


def _check_cong_quantized(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """Quantized registers stay in their wire ranges: C_cong and C_path
    in [0, 255], RedTE weights in [0, 256], the utilization EWMA in
    [0, 1]."""
    yield (((st.c_cong >= 0) & (st.c_cong <= 255)).all(),
           "cong_quantized: C_cong outside [0, 255]")
    yield (((st.c_path >= 0) & (st.c_path <= 255)).all(),
           "cong_quantized: C_path outside [0, 255]")
    yield (((st.redte_w >= 0) & (st.redte_w <= 256)).all(),
           "cong_quantized: RedTE weight outside [0, 256]")
    yield (((st.u_ewma >= 0.0) & (st.u_ewma <= 1.0 + 1e-5)).all(),
           "cong_quantized: utilization EWMA outside [0, 1]")


def _check_completion_identity(t: int, st, ar: SimArrays,
                               cfg: SimConfig) -> Checks:
    """A flow is never both done and active, and every completed flow
    carries a positive FCT."""
    yield ((~(st.done & st.active)).all(),
           "completion_identity: flow both done and active")
    yield (torch.where(st.done, st.fct_us > 0.0, True).all(),
           "completion_identity: completed flow with FCT <= 0")


def _check_pfc_lossless(t: int, st, ar: SimArrays, cfg: SimConfig) -> Checks:
    """PFC XOFF => no upstream forward. The gate cannot be observed after
    the step, so this is checked inline where the forward happens
    (``check_pfc``, from ``packet.make_step``); registered here for the
    coverage table."""
    return iter(())


INVARIANTS: Dict[str, Callable[..., Checks]] = {
    "queue_nonneg": _check_queue_nonneg,
    "buffer_bound": _check_buffer_bound,
    "byte_conservation": _check_byte_conservation,
    "ring_head": _check_ring_head,
    "clock_monotone": _check_clock_monotone,
    "signal_causality": _check_signal_causality,
    "cc_rate_bounds": _check_cc_rate_bounds,
    "cong_quantized": _check_cong_quantized,
    "completion_identity": _check_completion_identity,
    "pfc_lossless": _check_pfc_lossless,
}

# state field -> invariant names that constrain it (the reference's)
INVARIANT_COVERAGE: Dict[str, Tuple[str, ...]] = {
    "flow_path": ("byte_conservation", "clock_monotone"),
    "remaining": ("byte_conservation",),
    "rate": ("cc_rate_bounds",),
    "active": ("completion_identity", "cc_rate_bounds"),
    "done": ("completion_identity",),
    "fct_us": ("completion_identity",),
    "rtt_steps": ("clock_monotone",),
    "route_step": ("clock_monotone",),
    "last_dec": ("clock_monotone",),
    "cc_alpha": ("cc_rate_bounds",),
    "cc_target": ("cc_rate_bounds",),
    "q_bytes": ("queue_nonneg", "buffer_bound", "ring_head"),
    "hist_q": ("ring_head",),
    "hist_c": ("ring_head", "cong_quantized"),
    "u_ewma": ("cong_quantized",),
    "serv_bytes": ("queue_nonneg",),
    "c_cong": ("cong_quantized", "ring_head"),
    "c_path": ("cong_quantized",),
    "redte_w": ("cong_quantized",),
    # packet engine
    "fq": ("byte_conservation", "queue_nonneg"),
    "delivered": ("byte_conservation",),
    "last_tx": ("clock_monotone",),
    "pfc_pause": ("pfc_lossless", "ring_head"),
    "hist_pause": ("pfc_lossless", "ring_head"),
}

# state field -> why no runtime invariant applies (the reference's)
COVERAGE_EXEMPT: Dict[str, str] = {
    "extra_wait": "FCT wait estimate derived from q_bytes/link_cap, both "
                  "already range-checked; any non-negative estimate is a "
                  "legal model output",
    "route_nonce": "hash salt for re-decision keys — every value is a "
                   "valid (deterministic) decision key",
    "prev_delay": "TIMELY gradient memory; no physical bound beyond "
                  "finiteness (it stores a delay sample or 0)",
    "hist_u": "telemetry ring; offered/cap utilization legitimately "
              "exceeds 1 under overload, so no range bound exists",
    "link_alive": "boolean liveness mask written directly from the "
                  "failure schedule comparison",
    "cong": "core register-pipeline internals (Q/T/D EWMAs); the "
            "quantized output c_cong is range-checked instead",
    "credit": "pacing accumulator bounded by the rate-BDP window of the "
              "rate at injection time; the same step's CC update may "
              "shrink that window, so no post-step bound holds",
}


# --------------------------------------------------------- step plumbing
class Checker:
    """The checks of one run: ``check`` queues a step's ``(ok, msg)``,
    ``end_step`` folds the step into ``first``, the (n_checks,) int32
    first failing step of each check slot, on the device; ``throw``
    reads it once and raises the first failure."""

    def __init__(self) -> None:
        self._step: list = []
        self.msgs: Optional[Tuple[str, ...]] = None
        self.first: Optional[torch.Tensor] = None

    def check(self, ok: torch.Tensor, msg: str) -> None:
        self._step.append((ok, msg))

    def end_step(self, t: int) -> None:
        oks, msgs = zip(*self._step)
        self._step = []
        if self.first is None:
            self.msgs = msgs
            self.first = torch.full((len(msgs),), _NOT_YET, dtype=torch.int32,
                                    device=oks[0].device)
        elif msgs != self.msgs:
            raise RuntimeError("sanitize: a step's checks changed")
        fail = ~torch.stack(oks)
        self.first = torch.where(fail & (self.first == _NOT_YET), t,
                                 self.first)

    def throw(self) -> None:
        """Raise ``InvariantError`` for the first failure of the run: the
        earliest step, then the earliest check of that step."""
        if self.first is None:
            return
        first = self.first.tolist()
        step = min(first)
        if step != _NOT_YET:
            raise InvariantError(self.msgs[first.index(step)], step)


def step_check(t: int, st, ar: SimArrays, cfg: SimConfig, checker: Checker):
    """Every registered invariant against the end-of-step state, queued on
    ``checker`` after this step's inline checks. The mutation seam
    applies first; the state it returns is what the next step reads."""
    if _MUTATION is not None:
        st = _MUTATION(t, st)
    for check in INVARIANTS.values():
        for ok, msg in check(t, st, ar, cfg):
            checker.check(ok, msg)
    checker.end_step(t)
    return st


def pfc_gate(ok_hop: torch.Tensor, paused_next: torch.Tensor) -> torch.Tensor:
    """The packet engine's per-hop PFC send gate (checked mode only):
    ``ok_hop & ~paused_next``. The pfc_lossless mutation patches this to
    ignore the pause signal, proving ``check_pfc`` catches a broken
    gate."""
    return ok_hop & ~paused_next


def check_pfc(fwd: torch.Tensor, paused_next: torch.Tensor,
              checker: Checker) -> None:
    """Inline pfc_lossless check at the forward site: no bytes may be
    forwarded into a queue whose pause signal says XOFF."""
    checker.check(torch.where(paused_next, fwd <= 0.0, True).all(),
                  "pfc_lossless: bytes forwarded into a paused queue")

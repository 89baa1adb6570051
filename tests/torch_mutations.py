"""Seeded physics bugs for the port's sanitizer, one per invariant: the
counterpart of ``tests/mutations`` with torch states (same keys).

Each entry is a ``(t, state) -> state`` corruptor installed on
``repro_torch.netsim.sanitize._MUTATION``; the sanitizer applies it at
the top of ``step_check`` and the corrupted state flows onward through
the run. Each returns new tensors: the step updates some of the state's
tensors in place. ``signal_causality`` is seeded through
``SimArrays.path_sig_delay`` and ``pfc_lossless`` through the
``sanitize.pfc_gate`` seam (see ``tests/test_torch_sanitize.py``).
``chip_smoke.py`` runs the same corpus on the card.
"""
import dataclasses

import torch


def _queue_nonneg(t, st):
    return dataclasses.replace(st, q_bytes=st.q_bytes - 1.0)


def _buffer_bound(t, st):
    return dataclasses.replace(st, q_bytes=st.q_bytes + 1e12)


def _byte_conservation(t, st):
    return dataclasses.replace(
        st, remaining=torch.where(st.flow_path >= 0, st.remaining + 1e9,
                                  st.remaining))


def _ring_head(t, st):
    return dataclasses.replace(st, hist_q=st.hist_q + 1.0)


def _clock_monotone(t, st):
    return dataclasses.replace(
        st, route_step=torch.where(st.flow_path >= 0,
                                   torch.full_like(st.route_step, t + 10),
                                   st.route_step))


def _cc_rate_bounds(t, st):
    return dataclasses.replace(st, rate=torch.where(st.active, -1.0, st.rate))


def _cong_quantized(t, st):
    return dataclasses.replace(st, c_path=torch.full_like(st.c_path, 999))


def _completion_identity(t, st):
    return dataclasses.replace(st, done=st.done | st.active)


MUTATIONS = {
    "queue_nonneg": _queue_nonneg,
    "buffer_bound": _buffer_bound,
    "byte_conservation": _byte_conservation,
    "ring_head": _ring_head,
    "clock_monotone": _clock_monotone,
    "cc_rate_bounds": _cc_rate_bounds,
    "cong_quantized": _cong_quantized,
    "completion_identity": _completion_identity,
}


# ------------------------------------------- worker-side set-up helpers
# Initializers of ``repro_torch.netsim.sweep`` worker processes
# (``run_sharded(..., initializer=(fn, args))``), which must import them
# by name: ``tests/test_torch_sweep_mesh.py``.
def _first_done_split(t, st):
    """``queue_nonneg`` at the steps at which one of the world's flows has
    completed, ``cong_quantized`` at the others: worlds that hold
    different cells fail at different steps, or at one step by different
    invariants."""
    done = st.done.any()
    return dataclasses.replace(
        st, q_bytes=torch.where(done, st.q_bytes - 1.0, st.q_bytes),
        c_path=torch.where(done, st.c_path, torch.full_like(st.c_path, 999)))


def install(name: str) -> None:
    """Install corruptor ``name`` (a key of ``MUTATIONS``, or
    ``"first_done_split"``) on this process's sanitizer."""
    from repro_torch.netsim import sanitize
    sanitize._MUTATION = {**MUTATIONS,
                          "first_done_split": _first_done_split}[name]


def _raise_at(t, st, step):
    if t == step:
        raise ValueError(f"seeded worker failure at step {step}")
    return st


def install_raise_at(step: int) -> None:
    """A corruptor that raises ``ValueError`` at ``step`` (a checked run
    only)."""
    import functools

    from repro_torch.netsim import sanitize
    sanitize._MUTATION = functools.partial(_raise_at, step=step)


def exit_now(code: int) -> None:
    """End this process at once, as a crash would."""
    import os
    os._exit(code)

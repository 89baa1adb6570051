"""Wrapper of the hand-written CUDA monitor-tick kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/cong_update.py:74``
(``cong_update``, body ``_cong_kernel``); the source is
``csrc/cong_update.cu``, which states what bounds it on the H100 (bytes;
launch latency at the engine's 24-152 ports) and what its design does
about that. For CPU tensors the wrapper runs the plain version
(``ref.cong_update_ref``); for CUDA tensors it launches the kernel or
raises. ``cong_update.launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.tables import SwitchTables
from repro_torch.kernels import build, ref

NLEV = 16          # quantization levels the kernel is written for
_I32 = (-(1 << 31), (1 << 31) - 1)


def _check(name: str, x: torch.Tensor, shape, dev: torch.device) -> None:
    if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"cong_update: {name} must be a contiguous int32 tensor of shape "
            f"{shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def cong_update(state: CongState, queue_cells: torch.Tensor, now_us: int,
                tables: SwitchTables, params: CongParams = CongParams(),
                hist_c: torch.Tensor | None = None, slot: int = 0):
    """Fleet monitor tick over N ports. Returns ``(state', c_cong)``.

    On CUDA the kernel updates ``state``'s tensors IN PLACE and returns
    the same ``CongState``; ``c_cong`` is a new (N,) int32 tensor. With
    ``hist_c`` (N, HIST) given, ``c_cong`` is also written to column
    ``slot`` (already wrapped into ``[0, HIST)``).
    """
    dev = queue_cells.device
    if dev.type == "cpu":
        return ref.cong_update_ref(state, queue_cells, now_us, tables, params,
                                   hist_c, slot)
    if dev.type != "cuda":
        raise ValueError(f"cong_update: unsupported device {dev}")
    n = queue_cells.shape[0]
    if tables.num_levels != NLEV:
        raise ValueError(f"cong_update: the kernel takes num_levels == {NLEV}"
                         f", got {tables.num_levels}")
    for fname in ("queue_cur", "queue_prev", "trend", "dur_cnt",
                  "last_sample"):
        _check(fname, getattr(state, fname), (n,), dev)
    _check("queue_cells", queue_cells, (n,), dev)
    _check("trend_thresh", tables.trend_thresh, (n, NLEV - 1), dev)
    _check("q_thresh", tables.q_thresh, (NLEV - 1,), dev)
    _check("level_score", tables.level_score, (NLEV,), dev)
    hist_len = 0
    if hist_c is not None:
        hist_len = hist_c.shape[-1]
        _check("hist_c", hist_c, (n, hist_len), dev)
        if not 0 <= slot < hist_len:
            raise ValueError(f"cong_update: slot {slot} outside [0, {hist_len})")
    if not _I32[0] <= now_us <= _I32[1]:
        raise ValueError(f"cong_update: now_us {now_us} overflows int32")

    c_cong = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:                  # no ports: no launch
        return state, c_cong
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.load("cong_update").cong_update_launch(
            n, state.queue_cur.data_ptr(), state.queue_prev.data_ptr(),
            state.trend.data_ptr(), state.dur_cnt.data_ptr(),
            state.last_sample.data_ptr(), queue_cells.data_ptr(),
            tables.trend_thresh.data_ptr(), tables.q_thresh.data_ptr(),
            tables.level_score.data_ptr(), c_cong.data_ptr(),
            None if hist_c is None else hist_c.data_ptr(), hist_len,
            int(slot), int(now_us), int(tables.high_water_level),
            params.w_ql, params.w_tl, params.w_dp, params.ewma_k,
            params.dur_shift, params.s_cong, stream)
    build.check(err, "cong_update")
    cong_update.launches += 1
    return state, c_cong


cong_update.launches = 0

"""Wrappers of the hand-written CUDA monitor-tick kernels.

Replace the Pallas TPU kernel ``src/repro/kernels/cong_update.py:74``
(``cong_update``, body ``_cong_kernel``); the source is
``csrc/cong_update.cu``, which states what bounds it on the H100 (bytes;
launch latency at the engine's 24-152 ports) and what its design does
about that. Two entries share its register math:

- ``cong_update``: the TPU kernel's contract (queue cells in);
- ``monitor_tick``: the fluid engine's whole monitor tick (link queues
  in bytes to cells, registers, ``c_cong`` and the ``hist_c`` ring slot)
  in one launch, writing in place. ``MonitorTick`` is its launcher for a
  run: it checks the fixed tensors once, and a step passes only the
  queues, the time and the ring slot.

``switch_monitor`` is the switch's monitor pass (``core.switchd``)
through the ``cong_update`` entry: ``SwitchMonitor``, its launcher for a
switch, binds the switch's registers and ``c_cong`` once, and a tick
passes only the queue cells and the time; its launches count as
``cong_update``'s.

For CPU tensors the wrappers run the plain versions
(``ref.cong_update_ref``, ``ref.monitor_tick_ref``,
``ref.switch_monitor_ref``); for CUDA tensors they launch the kernel or
raise. ``cong_update.launches`` and ``monitor_tick.launches`` count
kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cong import CongParams, CongState
from repro_torch.core.tables import SwitchTables
from repro_torch.kernels import build, ref

NLEV = 16          # quantization levels the kernel is written for
_I32 = (-(1 << 31), (1 << 31) - 1)
_REGS = ("queue_cur", "queue_prev", "trend", "dur_cnt", "last_sample")


class _Args(ctypes.Structure):
    """``CongArgs`` of ``csrc/cong_update.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _REGS + (
        "trend_thresh", "q_thresh", "level_score", "c_cong", "hist_c")]
        + [("hist_len", ctypes.c_longlong), ("n", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "high_water", "w_ql", "w_tl", "w_dp", "ewma_k", "dur_shift",
            "s_cong")])


def _check(fn: str, name: str, x: torch.Tensor, dtype, shape,
           dev: torch.device) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def _now(fn: str, now_us: int) -> None:
    if not _I32[0] <= now_us <= _I32[1]:
        raise ValueError(f"{fn}: now_us {now_us} overflows int32")


def _args(fn: str, state: CongState, tables: SwitchTables,
          params: CongParams, c_cong: torch.Tensor,
          hist_c: torch.Tensor | None, dev: torch.device) -> _Args:
    """Check the tensors fixed for a launch (or a run) and pack them."""
    n = c_cong.shape[0]
    if tables.num_levels != NLEV:
        raise ValueError(f"{fn}: the kernel takes num_levels == {NLEV}"
                         f", got {tables.num_levels}")
    for name in _REGS:
        _check(fn, name, getattr(state, name), torch.int32, (n,), dev)
    _check(fn, "c_cong", c_cong, torch.int32, (n,), dev)
    _check(fn, "trend_thresh", tables.trend_thresh, torch.int32,
           (n, NLEV - 1), dev)
    _check(fn, "q_thresh", tables.q_thresh, torch.int32, (NLEV - 1,), dev)
    _check(fn, "level_score", tables.level_score, torch.int32, (NLEV,), dev)
    hist_len = 0
    if hist_c is not None:
        hist_len = hist_c.shape[-1]
        _check(fn, "hist_c", hist_c, torch.int32, (n, hist_len), dev)
    return _Args(*[getattr(state, r).data_ptr() for r in _REGS],
                 tables.trend_thresh.data_ptr(), tables.q_thresh.data_ptr(),
                 tables.level_score.data_ptr(), c_cong.data_ptr(),
                 None if hist_c is None else hist_c.data_ptr(), hist_len, n,
                 int(tables.high_water_level), params.w_ql, params.w_tl,
                 params.w_dp, params.ewma_k, params.dur_shift, params.s_cong)


def _launch(launcher, name: str, args_ref, q: torch.Tensor, slot: int,
            now_us: int, dev_index: int) -> None:
    """Call the C launcher of entry ``name`` on the current stream of the
    tensors' card."""
    if torch.cuda.current_device() == dev_index:
        err = launcher(args_ref, q.data_ptr(), slot, now_us,
                       build.raw_stream(dev_index))
    else:
        with torch.cuda.device(dev_index):
            err = launcher(args_ref, q.data_ptr(), slot, now_us,
                           build.raw_stream(dev_index))
    build.check(err, name)


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
    _check("cong_update", "queue_cells", queue_cells, torch.int32, (n,), dev)
    c_cong = torch.empty((n,), dtype=torch.int32, device=dev)
    args = _args("cong_update", state, tables, params, c_cong, hist_c, dev)
    if hist_c is not None and not 0 <= slot < args.hist_len:
        raise ValueError(f"cong_update: slot {slot} outside [0, {args.hist_len})")
    _now("cong_update", now_us)
    if n == 0:                  # no ports: no launch
        return state, c_cong
    _launch(build.load("cong_update").cong_update_launch, "cong_update",
            ctypes.byref(args), queue_cells, int(slot), int(now_us), dev.index)
    cong_update.launches += 1
    return state, c_cong


class SwitchMonitor:
    """The monitor pass of one switch on the card, one ``cong_update``
    launch a tick.

    Built once from the switch's registers ``state``, its ``c_cong``
    (both written in place by every tick), its tables and parameters,
    checked here. A call passes the tick's queue cells (N,) int32,
    checked cheaply, and the time.
    """

    def __init__(self, state: CongState, c_cong: torch.Tensor,
                 tables: SwitchTables, params: CongParams):
        dev = c_cong.device
        if dev.type != "cuda":
            raise ValueError(f"cong_update: unsupported device {dev}")
        self.args = _args("cong_update", state, tables, params, c_cong, None,
                          dev)
        self.bound = (state, *[getattr(state, r) for r in _REGS], c_cong)
        self.tables, self.params = tables, params
        self.n, self.dev_index = c_cong.shape[0], dev.index
        self.args_ref = ctypes.byref(self.args)
        self.launcher = build.load("cong_update").cong_update_launch

    def bound_to(self, state: CongState, c_cong: torch.Tensor) -> bool:
        """Whether these are the tensors the launcher was built on."""
        b = self.bound
        return (state is b[0] and state.queue_cur is b[1]
                and state.queue_prev is b[2] and state.trend is b[3]
                and state.dur_cnt is b[4] and state.last_sample is b[5]
                and c_cong is b[6])

    def __call__(self, queue_cells: torch.Tensor, now_us: int,
                 params: CongParams) -> None:
        if (queue_cells.dtype is not torch.int32 or queue_cells.dim() != 1
                or queue_cells.numel() != self.n
                or not queue_cells.is_contiguous()
                or queue_cells.get_device() != self.dev_index):
            _check("cong_update", "queue_cells", queue_cells, torch.int32,
                   (self.n,), torch.device("cuda", self.dev_index))
        if params is not self.params and params != self.params:
            raise ValueError("cong_update: the switch's monitor was built "
                             f"with {self.params}, not {params}")
        _now("cong_update", now_us)
        if self.n == 0:             # no ports: no launch
            return
        _launch(self.launcher, "cong_update", self.args_ref, queue_cells, 0,
                now_us, self.dev_index)
        cong_update.launches += 1


def switch_monitor(sw, queue_cells: torch.Tensor, now_us: int,
                   params: CongParams = CongParams()):
    """The monitor pass of switch ``sw`` (a ``core.switchd.SwitchState``)
    over its N ports from the queue cells (N,) int32. Returns
    ``(cong', c_cong)``.

    On CUDA one ``cong_update`` launch through the switch's launcher
    (``sw.monitor``) updates the registers and ``sw.c_cong`` IN PLACE and
    returns them; on the CPU the plain version returns new ones.
    """
    dev = queue_cells.device
    if dev.type == "cpu":
        return ref.switch_monitor_ref(sw, queue_cells, now_us, params)
    if dev.type != "cuda":
        raise ValueError(f"cong_update: unsupported device {dev}")
    monitor = sw.monitor
    if monitor is None or not monitor.bound_to(sw.cong, sw.c_cong):
        raise ValueError("cong_update: a switch on the card ticks through "
                         "the launcher make_switch bound to its registers "
                         "and c_cong, which it updates in place")
    monitor(queue_cells, int(now_us), params)
    return sw.cong, sw.c_cong


class MonitorTick:
    """The monitor tick of one run on the card, one launch a step.

    Built once from the tensors that stay fixed for the run (the
    registers of ``state``, the ``c_cong`` and ``hist_c`` the kernel
    writes in place, the switch tables), checked here; ``now_us_max`` is
    the largest time the run passes. A call passes the step's link
    queues ``q_bytes`` (L,) float32, checked cheaply, the time and the
    ring slot.
    """

    def __init__(self, state: CongState, c_cong: torch.Tensor,
                 hist_c: torch.Tensor, tables: SwitchTables,
                 params: CongParams, now_us_max: int):
        dev = c_cong.device
        if dev.type != "cuda":
            raise ValueError(f"monitor_tick: unsupported device {dev}")
        self.args = _args("monitor_tick", state, tables, params, c_cong,
                          hist_c, dev)
        _now("monitor_tick", now_us_max)
        self.now_us_max = now_us_max
        self.bound = (state, *[getattr(state, r) for r in _REGS], c_cong,
                      hist_c)
        self.tables = tables    # its tensors' pointers are in the struct
        self.n, self.dev_index = c_cong.shape[0], dev.index
        self.args_ref = ctypes.byref(self.args)
        self.launcher = build.load("cong_update").monitor_tick_launch

    def bound_to(self, state: CongState, c_cong: torch.Tensor,
                 hist_c: torch.Tensor) -> bool:
        """Whether these are the tensors the launcher was built on."""
        b = self.bound
        return (state is b[0] and state.queue_cur is b[1]
                and state.queue_prev is b[2] and state.trend is b[3]
                and state.dur_cnt is b[4] and state.last_sample is b[5]
                and c_cong is b[6] and hist_c is b[7])

    def __call__(self, q_bytes: torch.Tensor, now_us: int, slot: int) -> None:
        if (q_bytes.dtype is not torch.float32 or q_bytes.numel() != self.n
                or not q_bytes.is_contiguous() or q_bytes.dim() != 1
                or q_bytes.get_device() != self.dev_index):
            _check("monitor_tick", "q_bytes", q_bytes, torch.float32,
                   (self.n,), torch.device("cuda", self.dev_index))
        if not (0 <= slot < self.args.hist_len and 0 <= now_us <= self.now_us_max):
            raise ValueError(f"monitor_tick: slot {slot} or now_us {now_us} "
                             "outside the run")
        if self.n == 0:             # no ports: no launch
            return
        _launch(self.launcher, "monitor_tick", self.args_ref, q_bytes, slot,
                now_us, self.dev_index)
        monitor_tick.launches += 1


def monitor_tick(state: CongState, q_bytes: torch.Tensor, now_us: int,
                 tables: SwitchTables, params: CongParams,
                 hist_c: torch.Tensor, slot: int, c_cong: torch.Tensor):
    """The engine's monitor tick over L links: cells from ``q_bytes``
    (L,) float32, the register update, ``C_cong`` and its ring column
    ``slot`` of ``hist_c`` (L, HIST). Returns ``(state', c_cong')``.

    On CUDA one launch updates ``state``, ``c_cong`` and ``hist_c`` IN
    PLACE and returns ``(state, c_cong)``; on the CPU the plain version
    returns new registers and a new ``c_cong`` (``c_cong`` is not
    written) and writes the ring.
    """
    dev = q_bytes.device
    if dev.type == "cpu":
        return ref.monitor_tick_ref(state, q_bytes, now_us, tables, params,
                                    hist_c, slot)
    if dev.type != "cuda":
        raise ValueError(f"monitor_tick: unsupported device {dev}")
    MonitorTick(state, c_cong, hist_c, tables, params, now_us)(q_bytes, now_us,
                                                               slot)
    return state, c_cong


cong_update.launches = 0
monitor_tick.launches = 0

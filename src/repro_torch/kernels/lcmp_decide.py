"""Wrappers of the hand-written CUDA LCMP-decision kernels.

Replace the Pallas TPU kernel ``src/repro/kernels/lcmp_decide.py:93``
(``lcmp_decide``, body ``_decide_kernel``); the source is
``csrc/lcmp_decide.cu``, which states what bounds it on the H100 (bytes;
launch latency at the engine's 7-24 arrivals per step) and what its
design does about that. Two entries share its decision:

- ``lcmp_decide``: the TPU kernel's contract, a batch of decisions over
  given scores. The public layout is the reference's (F, P); the kernel
  takes P <= 8 and raises on wider candidate sets.
- ``route_arrivals``: the fluid engine's whole arrival routing for one
  step (candidates, liveness, the delayed congestion view, the lcmp or
  ecmp decision, the queue wait and RTT, and the eight per-flow fields
  written in place) in one launch. ``RouteArrivals`` is its launcher for
  a run: it checks the fixed tensors once, and a step passes only ``t``,
  the queues and the flow fields.

For CPU tensors the wrappers run the plain versions
(``ref.lcmp_decide_ref``, ``ref.route_arrivals_ref``); for CUDA tensors
they launch the kernel or raise. ``lcmp_decide.launches`` and
``route_arrivals.launches`` count kernel launches only. Flow ids are
int64 tensors holding uint32 values (see ``core.select``); the kernels
hash their low 32 bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.select import SelectParams
from repro_torch.kernels import build, ref

P_MAX = 8          # switch candidate sets are m <= 8 (paper §4)
H_MAX = 8          # hops a path may have in the route kernel
POLICY_CODES = {"lcmp": 0, "ecmp": 2}     # netsim.engine.POLICY_CODES
# (name, dtype) of the link queues the route reads and the per-flow
# fields it writes, in the order of ``StepTensors`` in the source
_STEP_TENSORS = (("q_bytes", torch.float32),
                 ("flow_path", torch.int32), ("remaining", torch.float32),
                 ("rate", torch.float32), ("cc_target", torch.float32),
                 ("active", torch.bool), ("extra_wait", torch.float32),
                 ("rtt_steps", torch.int32), ("route_step", torch.int32))


def lcmp_decide(flow_ids: torch.Tensor, c_path: torch.Tensor,
                c_cong: torch.Tensor, valid: torch.Tensor,
                params: SelectParams = SelectParams()) -> torch.Tensor:
    """flow_ids (F,) int64; c_path/c_cong (F, P) int32; valid (F, P)
    bool. Returns (F,) int32 candidate indices (-1: none valid)."""
    dev = flow_ids.device
    if dev.type == "cpu":
        return ref.lcmp_decide_ref(flow_ids, c_path, c_cong, valid, params)
    if dev.type != "cuda":
        raise ValueError(f"lcmp_decide: unsupported device {dev}")
    if c_path.dim() != 2:
        raise ValueError(f"lcmp_decide: c_path must be (F, P), got "
                         f"{tuple(c_path.shape)}")
    F, P = c_path.shape
    if not 1 <= P <= P_MAX:
        raise ValueError(f"lcmp_decide: the kernel takes 1 <= P <= {P_MAX}, "
                         f"got P={P}")
    for name, x, dtype, shape in (("flow_ids", flow_ids, torch.int64, (F,)),
                                  ("c_path", c_path, torch.int32, (F, P)),
                                  ("c_cong", c_cong, torch.int32, (F, P)),
                                  ("valid", valid, torch.bool, (F, P))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"lcmp_decide: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}{'' if x.is_contiguous() else ' (not contiguous)'}")

    out = torch.empty((F,), dtype=torch.int32, device=dev)
    if F == 0:                  # nothing to decide: no launch
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.load("lcmp_decide").lcmp_decide_launch(
            F, P, flow_ids.data_ptr(), c_path.data_ptr(), c_cong.data_ptr(),
            valid.data_ptr(), out.data_ptr(), params.alpha, params.beta,
            params.keep_num, params.cong_fallback, stream)
    build.check(err, "lcmp_decide")
    lcmp_decide.launches += 1
    return out


lcmp_decide.launches = 0


class _RouteArgs(ctypes.Structure):
    """``RouteArgs`` of ``csrc/lcmp_decide.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "arrivals", "f_pair", "f_id", "f_size", "pair_cand", "path_links",
        "path_sig", "path_prop", "path_cap", "link_cap", "link_alive",
        "hist_c", "c_path")]
        + [("hist_len", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "A", "K", "H", "policy", "alpha", "beta", "keep_num",
            "cong_fallback", "dt_us")])


class _StepTensors(ctypes.Structure):
    """``StepTensors`` of ``csrc/lcmp_decide.cu``: the pointers a step
    passes."""
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _STEP_TENSORS]


def _need(x: torch.Tensor, name: str, dtype, shape, dev: torch.device) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"route_arrivals: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {dev}, got {x.dtype} {tuple(x.shape)} "
            f"on {x.device}{'' if x.is_contiguous() else ' (not contiguous)'}")


def _within(x: torch.Tensor, name: str, lo: int, hi: int) -> None:
    """Index tables must stay inside what they index (one host sync, at
    set-up): the kernel reads through them unchecked."""
    if x.numel() and not (lo <= int(x.min()) and int(x.max()) < hi):
        raise ValueError(f"route_arrivals: {name} holds indices outside "
                         f"[{lo}, {hi})")


class RouteArrivals:
    """The arrival routing of one run on the card, one launch a step.

    Built once from the engine's arrays ``ar`` (``SimArrays``) and the
    state tensors the run keeps (``st.link_alive``, ``st.hist_c``,
    ``st.c_path``), checked here with their index ranges. A call
    ``(t, st)`` routes row ``t`` of ``ar.arrivals``: it passes the
    step's link queues and the eight per-flow fields of ``st``, each
    checked cheaply the first time the launcher sees it (a tensor must
    not be resized while the launcher may see it again), and the kernel
    writes those fields IN PLACE.
    """

    def __init__(self, ar, st, policy: str, select: SelectParams,
                 dt_us: int):
        dev = ar.arrivals.device
        if dev.type != "cuda":
            raise ValueError(f"route_arrivals: unsupported device {dev}")
        if policy not in POLICY_CODES:
            raise ValueError(f"route_arrivals: the kernel routes "
                             f"{tuple(POLICY_CODES)}, not {policy!r}")
        T, A = ar.arrivals.shape
        F, (NPAIR, K), (NP, H) = (ar.f_pair.shape[0], ar.pair_cand.shape,
                                  ar.path_links.shape)
        L, R = ar.link_cap.shape[0], st.hist_c.shape[-1]
        if not (1 <= K <= P_MAX and 1 <= H <= H_MAX):
            raise ValueError(f"route_arrivals: the kernel takes 1 <= K <= "
                             f"{P_MAX} candidates of 1 <= H <= {H_MAX} hops, "
                             f"got K={K}, H={H}")
        if not (1 <= R < 1 << 31 and A >= 1 and dt_us >= 1
                and select.keep_num >= 1):
            raise ValueError("route_arrivals: needs a ring, an arrival slot, "
                             "dt_us >= 1 and keep_num >= 1")
        for name, x, dtype, shape in (
                ("arrivals", ar.arrivals, torch.int32, (T, A)),
                ("f_pair", ar.f_pair, torch.int32, (F,)),
                ("f_id", ar.f_id, torch.int64, (F,)),
                ("f_size", ar.f_size, torch.float32, (F,)),
                ("pair_cand", ar.pair_cand, torch.int32, (NPAIR, K)),
                ("path_links", ar.path_links, torch.int32, (NP, H)),
                ("path_sig_delay", ar.path_sig_delay, torch.int32, (NP, H)),
                ("path_prop", ar.path_prop, torch.int32, (NP,)),
                ("path_cap", ar.path_cap, torch.float32, (NP,)),
                ("link_cap", ar.link_cap, torch.float32, (L,)),
                ("link_alive", st.link_alive, torch.bool, (L,)),
                ("hist_c", st.hist_c, torch.int32, (L, R)),
                ("c_path", st.c_path, torch.int32, (NP,))):
            _need(x, name, dtype, shape, dev)
        _within(ar.arrivals, "arrivals", -1, F)
        _within(ar.f_pair, "f_pair", 0, NPAIR)
        _within(ar.pair_cand, "pair_cand", -1, NP)
        _within(ar.path_links, "path_links", -1, L)
        self.args = _RouteArgs(
            ar.arrivals.data_ptr(), ar.f_pair.data_ptr(), ar.f_id.data_ptr(),
            ar.f_size.data_ptr(), ar.pair_cand.data_ptr(),
            ar.path_links.data_ptr(), ar.path_sig_delay.data_ptr(),
            ar.path_prop.data_ptr(), ar.path_cap.data_ptr(),
            ar.link_cap.data_ptr(), st.link_alive.data_ptr(),
            st.hist_c.data_ptr(), st.c_path.data_ptr(), R, A, K, H,
            POLICY_CODES[policy], select.alpha, select.beta, select.keep_num,
            select.cong_fallback, dt_us)
        # the tensors whose pointers the struct holds stay alive with it
        self.keep = (ar.arrivals, ar.f_pair, ar.f_id, ar.f_size, ar.pair_cand,
                     ar.path_links, ar.path_sig_delay, ar.path_prop,
                     ar.path_cap, ar.link_cap)
        self.bound = (st.link_alive, st.hist_c, st.c_path)
        self.T, self.F, self.L, self.dev_index = T, F, L, dev.index
        self.args_ref = ctypes.byref(self.args)
        self.launcher = build.load("lcmp_decide").route_arrivals_launch
        self.step = _StepTensors()
        self.step_ref = ctypes.byref(self.step)
        self.seen = [None] * len(_STEP_TENSORS)

    def bound_to(self, st) -> bool:
        """Whether ``st`` keeps the tensors the launcher was built on."""
        b = self.bound
        return st.link_alive is b[0] and st.hist_c is b[1] and st.c_path is b[2]

    def _bind_step(self, st) -> None:
        """Point ``self.step`` at the step's queues and eight per-flow
        fields. A tensor is checked when first seen; the step makes some
        anew each step (queues, rates, remaining bytes, activity) and
        keeps the others, which the kernel writes in place."""
        seen, fresh = self.seen, False
        for i, (name, dtype) in enumerate(_STEP_TENSORS):
            x = getattr(st, name)
            if x is not seen[i]:
                n = self.L if name == "q_bytes" else self.F
                setattr(self.step, name, self._ptr(x, name, dtype, n))
                seen[i] = x
                fresh = True
        if fresh:
            ptrs = {getattr(self.step, name) for name, _ in _STEP_TENSORS}
            if len(ptrs) != len(_STEP_TENSORS):
                self.seen = [None] * len(_STEP_TENSORS)
                raise ValueError(
                    "route_arrivals: two per-flow fields share memory")

    def _ptr(self, x: torch.Tensor, name: str, dtype, n: int) -> int:
        if (x.dtype is not dtype or x.numel() != n or not x.is_contiguous()
                or x.get_device() != self.dev_index):
            _need(x, name, dtype, (n,), torch.device("cuda", self.dev_index))
        return x.data_ptr()

    def __call__(self, t: int, st) -> None:
        if not 0 <= t < self.T:
            raise ValueError(f"route_arrivals: step {t} outside [0, {self.T})")
        self._bind_step(st)
        if torch.cuda.current_device() == self.dev_index:
            err = self.launcher(self.args_ref, self.step_ref, t,
                                build.raw_stream(self.dev_index))
        else:
            with torch.cuda.device(self.dev_index):
                err = self.launcher(self.args_ref, self.step_ref, t,
                                    build.raw_stream(self.dev_index))
        build.check(err, "route_arrivals")
        route_arrivals.launches += 1


def route_arrivals(t: int, st, ar, policy: str,
                   select: SelectParams = SelectParams(), dt_us: int = 200):
    """Route the flows arriving at step ``t`` (row ``t`` of
    ``ar.arrivals``) by ``policy`` and return the state with their eight
    per-flow fields written.

    On CUDA one launch writes the fields of ``st`` IN PLACE and returns
    ``st``; on the CPU the plain version returns a new state. Pads and
    flows with no valid candidate change nothing.
    """
    dev = ar.arrivals.device
    if dev.type == "cpu":
        return ref.route_arrivals_ref(t, st, ar, policy, select, dt_us)
    if dev.type != "cuda":
        raise ValueError(f"route_arrivals: unsupported device {dev}")
    RouteArrivals(ar, st, policy, select, dt_us)(t, st)
    return st


route_arrivals.launches = 0

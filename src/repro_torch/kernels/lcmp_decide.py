"""Wrappers of the hand-written CUDA path-decision kernels.

Replace the Pallas TPU kernel ``src/repro/kernels/lcmp_decide.py:93``
(``lcmp_decide``, body ``_decide_kernel``); the source is
``csrc/lcmp_decide.cu``, which states what bounds it on the H100 (bytes;
launch latency at the engine's 7-24 arrivals per step) and what its
design does about that. Three entries share its decision:

- ``lcmp_decide``: the TPU kernel's contract, a batch of LCMP decisions
  over given scores. The public layout is the reference's (F, P); the
  kernel takes P <= 8 and raises on wider candidate sets.
- ``route_arrivals``: the fluid engine's whole arrival routing for one
  step (candidates, liveness, the delayed congestion view, the policy's
  law, the queue wait and RTT, and the eight per-flow fields written in
  place) in one launch, for every law of ``POLICY_CODES``, or under
  ``"sweep"`` with each arrival's law read from its pair's code
  (``SimArrays.pair_policy``, a merged sweep world).
- ``decide``: the failover's and the re-decision's decisions for N
  given (hash key, pair) and a ring step for the congestion view,
  returning ``(k_idx, chosen)``: one call launches two kernels, a record
  per pair of the run into the launcher's table (``decide_pairs``), then
  a decision per thread from its pair's record (``decide_pick``).
  ``unpack_records`` reads that table on the host.
- ``switch_route``: a switch's whole batch of arrivals
  (``core.switchd.route_batch``: the flow-cache lookup with lazy
  failover, the refresh, the LCMP decision over the switch's <= 8
  candidates and the insert) in one call of two kernels, the cache
  written in place. ``SwitchRoute`` is its launcher for a switch.

``RouteArrivals`` is the launcher of a run for the last two: it checks
the fixed tensors once; a route step passes only ``t``, the queues and
the flow fields, a decision its keys and pairs. For CPU tensors the
wrappers run the plain versions (``ref.lcmp_decide_ref``,
``ref.route_arrivals_ref``, ``ref.decide_ref``); for CUDA tensors
``lcmp_decide`` and ``route_arrivals`` launch their kernel or raise, and
``decide`` raises: on the card only a run's launcher decides
(``RouteArrivals.decide``), so a decision never rebuilds one;
``switch_route`` runs ``ref.switch_route_ref`` on the CPU and the
switch's ``SwitchRoute`` on the card. ``lcmp_decide.launches``,
``route_arrivals.launches``, ``decide.launches`` and
``switch_route.launches`` count kernel launches only (one a call of
``decide`` or ``switch_route``). Flow ids are int64 tensors holding uint32 values (see
``core.select``); the kernels hash their low 32 bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.select import SelectParams
from repro_torch.kernels import build, ref

P_MAX = 8          # switch candidate sets are m <= 8 (paper §4)
H_MAX = 8          # hops a path may have in the route kernel
RECORD_WORDS = 16  # int32 words of a pair's record in decide's table
PATH_BITS = 28     # a record's path word: the path id low, a header nibble high
# every law of netsim.engine.POLICY_CODES, with its code
POLICY_CODES = {"lcmp": 0, "lcmp_w": 1, "ecmp": 2, "ucmp": 3, "wcmp": 4,
                "redte": 5, "fatpaths": 6, "amp": 7, "lcmp_r": 8,
                "matchrdma": 9}
# the laws whose record holds a candidate mask, not a slot order
MASK_LAWS = ("ecmp", "ucmp", "fatpaths", "amp", "matchrdma")
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
        "hist_c", "c_path", "path_cap_gbps", "path_len", "link_cap_gbps",
        "link_deg_step", "link_deg_factor", "redte_w", "pair_policy")]
        + [("hist_len", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "A", "K", "H", "policy", "alpha", "beta", "keep_num",
            "cong_fallback", "dt_us")]
        + [("records", ctypes.c_void_p), ("npair", ctypes.c_int)])


class _StepTensors(ctypes.Structure):
    """``StepTensors`` of ``csrc/lcmp_decide.cu``: the pointers a step
    passes."""
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _STEP_TENSORS]


def unpack_records(table: torch.Tensor) -> dict:
    """``decide``'s record table (NPAIR, ``RECORD_WORDS``) int32, as the
    kernel packs it (``csrc/lcmp_decide.cu``), unpacked into the fields of
    ``ref.decide_records_ref``: ``law``, ``n`` and ``mask`` (NPAIR,),
    ``order``, ``cum`` and ``path`` (NPAIR, 8), all int32. The header's
    24 low bits are the slot order (3 bits a rank) or, for
    ``MASK_LAWS``, the mask; the other field is 0."""
    w = table.to(torch.int64) & 0xFFFFFFFF
    hdr = sum(((w[:, k] >> PATH_BITS) & 15) << (4 * k) for k in range(P_MAX))
    law, sel = hdr >> 28, hdr & 0xFFFFFF
    masked = torch.isin(law, torch.tensor([POLICY_CODES[p] for p in MASK_LAWS],
                                          device=table.device))
    shift = 3 * torch.arange(P_MAX, device=table.device)
    low = w[:, :P_MAX] & ((1 << PATH_BITS) - 1)
    half = 1 << (PATH_BITS - 1)
    out = dict(law=law, n=(hdr >> 24) & 15,
               order=torch.where(masked[:, None], 0, (sel[:, None] >> shift) & 7),
               mask=torch.where(masked, sel, 0), cum=table[:, P_MAX:],
               path=(low ^ half) - half)
    return {k: v.to(torch.int32) for k, v in out.items()}


def _need(x: torch.Tensor, name: str, dtype, shape, dev: torch.device) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(
            f"route_arrivals: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {dev}, got {x.dtype} {tuple(x.shape)} "
            f"on {x.device}{'' if x.is_contiguous() else ' (not contiguous)'}")


def _within(x: torch.Tensor, name: str, lo: int, hi: int,
            fn: str = "route_arrivals") -> None:
    """Index tables must stay inside what they index (one host sync, at
    set-up): the kernel reads through them unchecked."""
    # read when a launcher is built (step 0 or a rebind) and for pairs
    # other than the run's own, never on a steady step
    # reprolint: ignore[DEV001] set-up read, once per launcher
    if x.numel() and not (lo <= int(x.min()) and int(x.max()) < hi):
        raise ValueError(f"{fn}: {name} holds indices outside [{lo}, {hi})")


class RouteArrivals:
    """The arrival routing and the decisions of one run on the card.

    Built once from the engine's arrays ``ar`` (``SimArrays``) and the
    state tensors the run keeps (``st.link_alive``, ``st.hist_c``,
    ``st.c_path``, ``st.redte_w``; the run updates them in place),
    checked here with their index ranges. A call ``(t, st)`` routes row
    ``t`` of ``ar.arrivals`` in one launch: it passes the step's link
    queues and the eight per-flow fields of ``st``, each checked cheaply
    the first time the launcher sees it (a tensor must not be resized
    while the launcher may see it again), and the kernel writes those
    fields IN PLACE. ``decide(t, fid, pair, sig_step)`` is one call of
    the ``decide`` entry: its two kernels, the first of which rewrites
    ``records``, the run's table of one record per pair (so decisions of
    one launcher go on one stream). Under ``policy="sweep"`` each decision
    takes the law ``ar.pair_policy`` holds for its pair, checked once to
    be one of ``sweep_policies``.
    """

    def __init__(self, ar, st, policy: str, select: SelectParams,
                 dt_us: int, sweep_policies: tuple = tuple(POLICY_CODES)):
        dev = ar.arrivals.device
        if dev.type != "cuda":
            raise ValueError(f"route_arrivals: unsupported device {dev}")
        if policy not in POLICY_CODES and policy != "sweep":
            raise ValueError(f"route_arrivals: the kernel routes by the laws "
                             f"{tuple(POLICY_CODES)} or a sweep's, not "
                             f"{policy!r}")
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
                ("c_path", st.c_path, torch.int32, (NP,)),
                ("path_cap_gbps", ar.path_cap_gbps, torch.int32, (NP,)),
                ("path_len", ar.path_len, torch.int32, (NP,)),
                ("link_cap_gbps", ar.link_cap_gbps, torch.int32, (L,)),
                ("link_deg_step", ar.link_deg_step, torch.int32, (L,)),
                ("link_deg_factor", ar.link_deg_factor, torch.float32, (L,)),
                ("redte_w", st.redte_w, torch.int32, (NPAIR, K))):
            _need(x, name, dtype, shape, dev)
        _within(ar.arrivals, "arrivals", -1, F)
        _within(ar.f_pair, "f_pair", 0, NPAIR)
        _within(ar.pair_cand, "pair_cand", -1, NP)
        _within(ar.path_links, "path_links", -1, L)
        if NP > 1 << (PATH_BITS - 1):
            raise ValueError(f"route_arrivals: decide's table holds path ids "
                             f"below 2**{PATH_BITS - 1}, got {NP} paths")
        pair_policy = 0
        if policy == "sweep":
            codes = ar.pair_policy
            if codes is None or codes.device != dev or codes.dtype != \
                    torch.int32 or tuple(codes.shape) != (NPAIR,) \
                    or not codes.is_contiguous():
                raise ValueError(
                    f"route_arrivals: a sweep routes by per-pair law codes, "
                    f"ar.pair_policy an int32 tensor of shape ({NPAIR},) on "
                    f"{dev}, got {None if codes is None else codes.dtype}")
            swept = {POLICY_CODES[p] for p in sweep_policies}
            # reprolint: ignore[DEV001,DEV004] set-up read, once per launcher
            got = set(torch.unique(codes).tolist())
            if not got <= swept:
                raise ValueError(f"route_arrivals: pair_policy holds law codes "
                                 f"{sorted(got - swept)} outside the swept "
                                 f"{tuple(sweep_policies)}")
            pair_policy = codes.data_ptr()
        self.records = torch.empty((NPAIR, RECORD_WORDS), dtype=torch.int32,
                                   device=dev)
        self.args = _RouteArgs(
            ar.arrivals.data_ptr(), ar.f_pair.data_ptr(), ar.f_id.data_ptr(),
            ar.f_size.data_ptr(), ar.pair_cand.data_ptr(),
            ar.path_links.data_ptr(), ar.path_sig_delay.data_ptr(),
            ar.path_prop.data_ptr(), ar.path_cap.data_ptr(),
            ar.link_cap.data_ptr(), st.link_alive.data_ptr(),
            st.hist_c.data_ptr(), st.c_path.data_ptr(),
            ar.path_cap_gbps.data_ptr(), ar.path_len.data_ptr(),
            ar.link_cap_gbps.data_ptr(), ar.link_deg_step.data_ptr(),
            ar.link_deg_factor.data_ptr(), st.redte_w.data_ptr(), pair_policy,
            R, A, K, H, POLICY_CODES.get(policy, -1), select.alpha,
            select.beta, select.keep_num, select.cong_fallback, dt_us,
            self.records.data_ptr(), NPAIR)
        # the tensors whose pointers the struct holds stay alive with it
        self.keep = (ar.arrivals, ar.f_pair, ar.f_id, ar.f_size, ar.pair_cand,
                     ar.path_links, ar.path_sig_delay, ar.path_prop,
                     ar.path_cap, ar.link_cap, ar.path_cap_gbps, ar.path_len,
                     ar.link_cap_gbps, ar.link_deg_step, ar.link_deg_factor,
                     ar.pair_policy)
        self.bound = (st.link_alive, st.hist_c, st.c_path, st.redte_w)
        self.f_pair, self.NPAIR = ar.f_pair, NPAIR
        self.T, self.F, self.L, self.dev_index = T, F, L, dev.index
        self.args_ref = ctypes.byref(self.args)
        lib = build.load("lcmp_decide")
        self.launcher, self.decider = lib.route_arrivals_launch, lib.decide_launch
        self.stage_launchers = (lib.decide_pairs_launch, lib.decide_pick_launch)
        self.step = _StepTensors()
        self.step_ref = ctypes.byref(self.step)
        self.seen = [None] * len(_STEP_TENSORS)

    def bound_to(self, st) -> bool:
        """Whether ``st`` keeps the tensors the launcher was built on."""
        b = self.bound
        return (st.link_alive is b[0] and st.hist_c is b[1]
                and st.c_path is b[2] and st.redte_w is b[3])

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

    def _launch(self, fn, *args) -> int:
        """``fn(*args, stream)`` on the launcher's card and its current
        stream, entering the card's context only when it is not current."""
        if torch.cuda.current_device() == self.dev_index:
            return fn(*args, build.raw_stream(self.dev_index))
        with torch.cuda.device(self.dev_index):
            return fn(*args, build.raw_stream(self.dev_index))

    def __call__(self, t: int, st) -> None:
        if not 0 <= t < self.T:
            raise ValueError(f"route_arrivals: step {t} outside [0, {self.T})")
        self._bind_step(st)
        build.check(self._launch(self.launcher, self.args_ref, self.step_ref, t),
                    "route_arrivals")
        route_arrivals.launches += 1

    def _decisions(self, t: int, fid: torch.Tensor, pair: torch.Tensor,
                   sig_step: int) -> torch.Tensor:
        """Check a decision's inputs; returns the (2, N) int32 output."""
        N = fid.shape[0] if fid.dim() == 1 else -1
        self._ptr(fid, "decide fid", torch.int64, N)
        if pair is not self.f_pair:     # the engine's pairs were checked
            self._ptr(pair, "decide pair", torch.int32, N)
            _within(pair, "decide pair", 0, self.NPAIR)
        if not (-(1 << 31) <= min(t, sig_step) <= max(t, sig_step) < 1 << 31):
            raise ValueError(f"decide: t and sig_step must fit int32, got "
                             f"t={t}, sig_step={sig_step}")
        return torch.empty((2, N), dtype=torch.int32, device=fid.device)

    def decide(self, t: int, fid: torch.Tensor, pair: torch.Tensor,
               sig_step: int):
        """One ``decide`` call for N decisions: hash keys ``fid`` (N,)
        int64, pairs ``pair`` (N,) int32; the congestion view reads ring
        step ``sig_step`` (may be negative), ``matchrdma``'s degrade
        schedule applies at ``t``. Returns ``(k_idx, chosen)``, (N,) int32
        each, -1 where no candidate is valid."""
        out = self._decisions(t, fid, pair, sig_step)
        k_idx, chosen = out
        if out.shape[1] == 0:           # nothing to decide: no launch
            return k_idx, chosen
        build.check(self._launch(self.decider, self.args_ref, out.shape[1],
                                 fid.data_ptr(), pair.data_ptr(),
                                 k_idx.data_ptr(), chosen.data_ptr(), t,
                                 sig_step), "decide")
        decide.launches += 1
        return k_idx, chosen

    def decide_stages(self, t: int, fid: torch.Tensor, pair: torch.Tensor,
                      sig_step: int):
        """The two kernels of ``decide(t, fid, pair, sig_step)`` as two
        callables that launch one each, for timing them apart: the pairs'
        records, then the N picks from the table as it stands. Not
        counted as ``decide`` launches."""
        out = self._decisions(t, fid, pair, sig_step)
        pairs_fn, pick_fn = self.stage_launchers

        def pairs():
            build.check(self._launch(pairs_fn, self.args_ref, t, sig_step),
                        "decide_pairs")

        def pick():                     # holds fid, pair and out alive
            build.check(self._launch(pick_fn, self.args_ref, out.shape[1],
                                     fid.data_ptr(), pair.data_ptr(),
                                     out[0].data_ptr(), out[1].data_ptr()),
                        "decide_pick")
        return pairs, pick


def route_arrivals(t: int, st, ar, policy: str,
                   select: SelectParams = SelectParams(), dt_us: int = 200,
                   sweep_policies: tuple = tuple(POLICY_CODES)):
    """Route the flows arriving at step ``t`` (row ``t`` of
    ``ar.arrivals``) by ``policy`` (under ``"sweep"``, each pair's law of
    ``sweep_policies``) and return the state with their eight per-flow
    fields written.

    On CUDA one launch writes the fields of ``st`` IN PLACE and returns
    ``st``; on the CPU the plain version returns a new state. Pads and
    flows with no valid candidate change nothing.
    """
    dev = ar.arrivals.device
    if dev.type == "cpu":
        return ref.route_arrivals_ref(t, st, ar, policy, select, dt_us,
                                      sweep_policies)
    if dev.type != "cuda":
        raise ValueError(f"route_arrivals: unsupported device {dev}")
    RouteArrivals(ar, st, policy, select, dt_us, sweep_policies)(t, st)
    return st


route_arrivals.launches = 0


def decide(t: int, fid: torch.Tensor, pair: torch.Tensor, st, ar,
           policy: str, select: SelectParams = SelectParams(),
           sig_step=None, sweep_policies: tuple = tuple(POLICY_CODES)):
    """``(k_idx, chosen)`` of ``policy``'s law for N decisions (hash keys
    ``fid`` (N,) int64, pairs ``pair`` (N,) int32), the congestion view
    read at ring step ``sig_step`` (default ``t``): the plain version on
    the CPU. On the card a run's ``RouteArrivals.decide`` launches the
    two kernels (``netsim.engine.StepLaunchers.decide``); this raises
    there."""
    dev = ar.pair_cand.device
    if dev.type == "cpu":
        sig = t if sig_step is None else sig_step
        return ref.decide_ref(t, fid, pair, st, ar, policy, select, sig,
                              sweep_policies)
    raise ValueError(f"decide: on {dev} a run's launcher decides "
                     f"(RouteArrivals.decide, as engine.StepLaunchers does)")


decide.launches = 0


class _SwitchArgs(ctypes.Structure):
    """``SwitchArgs`` of ``csrc/lcmp_decide.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "c_path", "cand_port", "cand_valid", "c_cong", "port_alive",
        "flow_id", "out_idx", "last_seen", "valid", "win")]
        + [(n, ctypes.c_int) for n in (
            "capacity", "P", "alpha", "beta", "keep_num", "cong_fallback")])


# (name, dtype, length) of the switch tensors ``SwitchRoute`` binds, the
# lengths P (candidates), N (ports) and C (cache slots)
_SWITCH_TENSORS = (("c_path", torch.int32, "P"), ("cand_port", torch.int32, "P"),
                   ("cand_valid", torch.bool, "P"), ("c_cong", torch.int32, "N"),
                   ("port_alive", torch.bool, "N"))
_CACHE_TENSORS = (("flow_id", torch.int64), ("out_idx", torch.int32),
                  ("last_seen", torch.int32), ("valid", torch.bool))


class SwitchRoute:
    """A switch's batches of arrivals on the card, one ``switch_route``
    call (two kernels) a batch.

    Built once from the switch ``sw`` (a ``core.switchd.SwitchState``)
    and its selection parameters: the candidates' ``c_path``,
    ``cand_port`` and ``cand_valid``, the ports' ``c_cong`` and
    ``port_alive`` and the four tensors of its flow cache, checked here
    with the candidates' port range (one host read), and a (C,) int32
    scratch of slot bids held at -1 between batches. A call passes the
    batch's flow ids and the time; the kernels write the cache IN PLACE,
    so the switch must keep these tensors (``core.switchd`` updates them
    in place on the card).
    """

    def __init__(self, sw, params: SelectParams):
        dev = sw.c_path.device
        if dev.type != "cuda":
            raise ValueError(f"switch_route: unsupported device {dev}")
        P, N = sw.c_path.shape[0], sw.port_alive.shape[0]
        C = sw.cache.flow_id.shape[0]
        if not 1 <= P <= P_MAX:
            raise ValueError(f"switch_route: the kernel takes 1 <= P <= "
                             f"{P_MAX} candidates, got P={P}")
        if not (1 <= C < 1 << 31 and params.keep_num >= 1):
            raise ValueError("switch_route: needs 1 <= capacity < 2**31 and "
                             "keep_num >= 1")
        lengths = {"P": P, "N": N}
        tensors = [(name, getattr(sw, name), dtype, (lengths[n],))
                   for name, dtype, n in _SWITCH_TENSORS] + [
            (f"cache.{name}", getattr(sw.cache, name), dtype, (C,))
            for name, dtype in _CACHE_TENSORS]
        for name, x, dtype, shape in tensors:
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
                    or not x.is_contiguous():
                raise ValueError(
                    f"switch_route: {name} must be a contiguous {dtype} "
                    f"tensor of shape {shape} on {dev}, got {x.dtype} "
                    f"{tuple(x.shape)} on {x.device}")
        _within(sw.cand_port, "cand_port", 0, N, "switch_route")
        self.win = torch.full((C,), -1, dtype=torch.int32, device=dev)
        self.args = _SwitchArgs(
            *[x.data_ptr() for _, x, _, _ in tensors], self.win.data_ptr(),
            C, P, params.alpha, params.beta, params.keep_num,
            params.cong_fallback)
        # the tensors whose pointers the struct holds stay alive with it
        self.bound = tuple(x for _, x, _, _ in tensors)
        self.params, self.dev_index = params, dev.index
        self.args_ref = ctypes.byref(self.args)
        self.launcher = build.load("lcmp_decide").switch_route_launch

    def bound_to(self, sw) -> bool:
        """Whether ``sw`` keeps the tensors the launcher was built on."""
        b, c = self.bound, sw.cache
        return (sw.c_path is b[0] and sw.cand_port is b[1]
                and sw.cand_valid is b[2] and sw.c_cong is b[3]
                and sw.port_alive is b[4] and c.flow_id is b[5]
                and c.out_idx is b[6] and c.last_seen is b[7]
                and c.valid is b[8])

    def __call__(self, flow_ids: torch.Tensor, now_us: int, params: SelectParams):
        """Route a batch: ``flow_ids`` (F,) int64 holding uint32 values.
        Returns ``(choice, is_new)``, (F,) int32 and (F,) bool."""
        if (flow_ids.dtype is not torch.int64 or flow_ids.dim() != 1
                or not flow_ids.is_contiguous()
                or flow_ids.get_device() != self.dev_index):
            raise ValueError(
                f"switch_route: flow_ids must be a contiguous 1-D int64 tensor "
                f"on cuda:{self.dev_index}, got {flow_ids.dtype} "
                f"{tuple(flow_ids.shape)} on {flow_ids.device}")
        if params is not self.params and params != self.params:
            raise ValueError(f"switch_route: the switch's launcher was built "
                             f"with {self.params}, not {params}")
        if not -(1 << 31) <= now_us < 1 << 31:
            raise ValueError(f"switch_route: now_us {now_us} overflows int32")
        F = flow_ids.shape[0]
        choice = torch.empty((F,), dtype=torch.int32, device=flow_ids.device)
        is_new = torch.empty((F,), dtype=torch.bool, device=flow_ids.device)
        if F == 0:                      # nothing to route: no launch
            return choice, is_new
        if torch.cuda.current_device() == self.dev_index:
            err = self.launcher(self.args_ref, F, flow_ids.data_ptr(),
                                choice.data_ptr(), is_new.data_ptr(), now_us,
                                build.raw_stream(self.dev_index))
        else:
            with torch.cuda.device(self.dev_index):
                err = self.launcher(self.args_ref, F, flow_ids.data_ptr(),
                                    choice.data_ptr(), is_new.data_ptr(),
                                    now_us, build.raw_stream(self.dev_index))
        build.check(err, "switch_route")
        switch_route.launches += 1
        return choice, is_new


def switch_route(sw, flow_ids: torch.Tensor, now_us: int,
                 params: SelectParams = SelectParams()):
    """A batch of arrivals at switch ``sw`` (a ``core.switchd.SwitchState``):
    ``flow_ids`` (F,) int64. Returns ``(cache', choice, is_new)``:
    choice (F,) int32 candidate indices (-1: none valid), is_new (F,)
    bool.

    On CUDA one call of the switch's launcher (``sw.route``, built by
    ``make_switch``) writes ``sw.cache`` IN PLACE and returns it; on the
    CPU the plain version returns a new cache.
    """
    dev = flow_ids.device
    if dev.type == "cpu":
        return ref.switch_route_ref(sw, flow_ids, now_us, params)
    if dev.type != "cuda":
        raise ValueError(f"switch_route: unsupported device {dev}")
    route = sw.route
    if route is None or not route.bound_to(sw):
        raise ValueError("switch_route: a switch on the card routes through "
                         "the launcher make_switch bound to its candidates, "
                         "ports and cache, which it updates in place")
    choice, is_new = route(flow_ids, int(now_us), params)
    return sw.cache, choice, is_new


switch_route.launches = 0

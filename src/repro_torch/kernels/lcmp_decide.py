"""Wrapper of the hand-written CUDA batched LCMP-decision kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/lcmp_decide.py:93``
(``lcmp_decide``, body ``_decide_kernel``); the source is
``csrc/lcmp_decide.cu``, which states what bounds it on the H100 (bytes;
launch latency at the engine's 7-24 arrivals per step) and what its
design does about that. For CPU tensors the wrapper runs the plain
version (``ref.lcmp_decide_ref``); for CUDA tensors it launches the
kernel or raises. ``lcmp_decide.launches`` counts kernel launches only.

The public layout is the reference's (F, P); the kernel takes P <= 8 and
raises on wider candidate sets. Flow ids are int64 tensors holding
uint32 values (see ``core.select``); the kernel hashes their low 32 bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.select import SelectParams
from repro_torch.kernels import build, ref

P_MAX = 8          # switch candidate sets are m <= 8 (paper §4)


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

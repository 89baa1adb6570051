"""Bad: the step writes a SimState field in place (`credit.copy_`) that
the sanitizer registries neither cover nor exempt."""
import dataclasses

import torch


@dataclasses.dataclass
class SimState:
    remaining: torch.Tensor
    credit: torch.Tensor


def _check_bytes(t, st, ar, cfg):
    yield (st.remaining >= 0).all(), "byte_conservation"


INVARIANTS = {"byte_conservation": _check_bytes}
INVARIANT_COVERAGE = {"remaining": ("byte_conservation",)}
COVERAGE_EXEMPT = {}


def make_step(ar, cfg):
    def step(st: SimState, t: int) -> SimState:
        st.credit.copy_(torch.clamp_min(st.credit - 1.0, 0.0))
        return dataclasses.replace(st, remaining=st.remaining - 1.0)
    return step

"""Good: every SimState field the step mutates, returned or written in
place, has a registered invariant or an exemption."""
import dataclasses

import torch

HIST = 64
MAX_DELAY = 8

if MAX_DELAY >= HIST:
    raise ValueError("history ring too small for the max delay")


@dataclasses.dataclass
class SimState:
    q_bytes: torch.Tensor
    hist_q: torch.Tensor
    link_alive: torch.Tensor


def _check_queue(t, st, ar, cfg):
    yield (st.q_bytes >= 0).all(), "queue_nonneg"


INVARIANTS = {"queue_nonneg": _check_queue}
INVARIANT_COVERAGE = {"q_bytes": ("queue_nonneg",),
                      "hist_q": ("queue_nonneg",)}
COVERAGE_EXEMPT = {"link_alive": "liveness mask written from the "
                                 "failure schedule"}


def make_step(ar, cfg):
    def step(st: SimState, t: int) -> SimState:
        q = torch.clamp_min(st.q_bytes - 1.0, 0.0)
        st.hist_q[:, t % HIST] = q
        st.link_alive.copy_(t < ar.link_fail_step)
        return dataclasses.replace(st, q_bytes=q)
    return step

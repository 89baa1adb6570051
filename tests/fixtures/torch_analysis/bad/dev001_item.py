"""Bad: `.item()` of a device value inside an engine step: a host sync
on every step."""
import torch


def make_step(ar, cfg):
    def step(st: "SimState", t: int):
        total = st.remaining.sum().item()
        st.rate.mul_(0.5 if total > 0 else 1.0)
        return st
    return step

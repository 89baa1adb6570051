"""Bad: Python `if` on a device value inside an engine step: an
implicit bool(), a host sync."""
import torch


def make_step(ar, cfg):
    def step(st: "SimState", t: int):
        if (st.remaining > 0).any():
            st.rate.mul_(0.5)
        return st
    return step

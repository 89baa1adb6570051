"""Bad: an index_add_ into an accumulator made without a stated dtype:
on the card the order of the float32 atomics shows in the sum."""
import torch


def make_step(ar: "SimArrays", cfg):
    L = ar.link_cap.shape[0]

    def step(st: "SimState", t: int):
        load = torch.zeros(L, device=st.rate.device).index_add_(
            0, st.flow_path.clamp_min(0), st.rate)
        st.rate.copy_(torch.where(load > ar.link_cap[0], st.rate, 0.0))
        return st
    return step

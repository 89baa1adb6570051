"""Bad: boolean-mask indexing in the decode step: its output shape
depends on the data (a nonzero and a sync), so no CUDA graph can
capture the step."""
import torch


def decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor, pos):
    x = params["embed"][tokens]
    live = x.abs() > 0
    return x[live], cache

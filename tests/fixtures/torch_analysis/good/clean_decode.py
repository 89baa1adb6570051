"""Good: a decode step that keeps its position on the card, fills its
scalars on the card, writes its cache in place at a device position and
masks with torch.where."""
import torch


def decode_step(params: dict, cfg, cache: dict, tokens: torch.Tensor, pos):
    pos = (pos.to(tokens.device, torch.long) if isinstance(pos, torch.Tensor)
           else torch.full((), pos, dtype=torch.long, device=tokens.device))
    x = params["embed"][tokens]
    if cfg.scale_embed:                      # a config branch: fine
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    kc = cache["k"]
    kc.index_copy_(1, pos.reshape(1), x)
    kpos = torch.arange(kc.shape[1], device=x.device)
    logits = torch.where(kpos <= pos, kc.sum(-1), -1e30)
    return logits, cache

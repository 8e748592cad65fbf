"""Per-row token sampling over (B, V) logits (counterpart of
`mxnet_tpu/serving/sampling.py`).

Per row: temperature <= 0 is greedy argmax; otherwise the logits are
divided by the temperature, cut to the top_k best (top_k > 0), then to
the nucleus (0 < top_p < 1: the smallest descending-probability prefix
whose mass reaches top_p; the top token always survives), and one token
is drawn from the row's own `torch.Generator`. A row's stream depends on
its request alone, so evicting one request never shifts another's.
"""
from __future__ import annotations

import torch

__all__ = ["filter_logits", "sample_tokens"]


def filter_logits(logits, temperature, top_k, top_p):
    """Temperature-scaled fp32 logits with every token outside the row's
    top-k / nucleus set at -inf. temperature, top_p (B,) float; top_k
    (B,) int (0 = off)."""
    lg = logits.float()
    t = temperature.to(lg.device, torch.float32)
    lg = lg / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    V = lg.shape[-1]
    neg = float("-inf")

    k = top_k.to(lg.device, torch.int64)
    asc = lg.sort(dim=-1).values
    kth = asc.gather(-1, (V - k).clamp(0, V - 1)[:, None])       # (B, 1)
    lg = lg.masked_fill((k > 0)[:, None] & (lg < kth), neg)

    p = top_p.to(lg.device, torch.float32)
    desc = lg.sort(dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    keep = probs.cumsum(dim=-1) - probs < p[:, None]     # prefix mass < p
    thresh = torch.where(keep, desc, float("inf")).amin(dim=-1,
                                                        keepdim=True)
    use_p = (p > 0) & (p < 1)
    return lg.masked_fill(use_p[:, None] & (lg < thresh), neg)


def sample_tokens(logits, generators, temperature, top_k, top_p):
    """(B,) int64 tokens. `generators` holds one `torch.Generator` per
    row on the logits' device (None for rows that never sample);
    temperature, top_k, top_p are (B,) tensors."""
    tok = logits.float().argmax(dim=-1)
    hot = (temperature > 0).nonzero().flatten().tolist()
    if hot:
        lg = filter_logits(logits, temperature, top_k, top_p)
        probs = torch.softmax(lg, dim=-1)
        for i in hot:
            tok[i] = torch.multinomial(probs[i], 1,
                                       generator=generators[i])[0]
    return tok

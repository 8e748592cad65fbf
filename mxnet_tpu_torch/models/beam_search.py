"""Beam expansion (counterpart of `mxnet_tpu/models/beam_search.py`'s
`beam_expand_topk`, which `llama_infer.generate_beam` uses; the
encoder-decoder translator waits for the Transformer)."""
from __future__ import annotations

import torch

__all__ = ["beam_expand_topk"]


def beam_expand_topk(scores, logp, finished, eos_id):
    """One beam-search expansion: scores (B, W), logp (B, W, V),
    finished (B, W) -> (new_scores, parent, token, new_finished), all
    (B, W). Finished beams may only extend with eos at zero cost, so
    their scores freeze."""
    B, W, V = logp.shape
    if eos_id is not None:
        frozen = torch.full((V,), float("-inf"), dtype=logp.dtype,
                            device=logp.device)
        frozen[eos_id] = 0.0
        logp = torch.where(finished[..., None], frozen, logp)
    total = scores[..., None] + logp                      # (B, W, V)
    new_scores, flat = total.reshape(B, W * V).topk(W, dim=-1)
    parent = flat // V
    tok = flat % V
    new_finished = finished.gather(1, parent)
    if eos_id is not None:
        new_finished = new_finished | (tok == eos_id)
    return new_scores, parent, tok, new_finished

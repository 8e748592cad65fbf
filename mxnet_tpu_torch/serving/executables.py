"""The serving prefill and decode tick over the paged pool (counterpart of
`mxnet_tpu/serving/executables.py`, `paged_programs`' prefill and
decode).

PyTorch runs eagerly, so there is nothing to compile: a `Program` is the
plain function plus a count of its calls, run under inference mode.

    prefill(params, pages, bt_row, ids, valid_len) -> last_logits (1, V)
        One request (batch 1, right-padded to max_prompt_len) through
        the layer math; its k/v rows go straight into its blocks, the
        padding rows into scratch block 0.

    decode(params, pages, block_tables, pos, last_logits, generators,
           temps, top_ks, top_ps, active) -> (tokens (B,), logits (B, V))
        One continuous-batching tick: sample each row from the PREVIOUS
        tick's logits, run one step for every batch slot through the
        paged decode kernel, write the new rows into the pool. Inactive
        slots write scratch block 0 and attend one position; the
        scheduler discards their outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_decode import flash_decode_paged
from ..models import llama_math
from .sampling import sample_tokens

__all__ = ["Program", "paged_programs", "write_rows"]


class Program:
    """A named serving function and its call count."""

    def __init__(self, name, fn):
        self.name = name
        self.fn = fn
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        with torch.inference_mode():
            return self.fn(*args)


def write_rows(pg, blk_ids, offs, k_rows, v_rows):
    """Scatter per-token rows (T, K, d) into the pool at (block, offset)
    pairs (T,). The JAX package returns a new pool from `.at[].set` on a
    donated buffer; here the write is an in-place `index_put_` into the
    pool itself, through an (N, bs, K, d) view so the token axis leads."""
    idx = (blk_ids.long(), offs.long())
    pg["k"].permute(0, 2, 1, 3).index_put_(idx, k_rows)
    pg["v"].permute(0, 2, 1, 3).index_put_(idx, v_rows)


def paged_programs(cfg, *, batch_slots: int, block_size: int):
    """The prefill and decode `Program`s for one model config and pool
    geometry."""
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps, base, bs = cfg.rms_eps, cfg.rope_base, block_size

    def prefill(params, pages, bt_row, ids, valid_len):
        B, T = ids.shape                                   # B == 1
        positions = torch.arange(T, device=ids.device)
        # padding tokens (t >= valid) sink into scratch block 0; the
        # forward still runs over the whole padded prompt (causal
        # attention is self-contained), only the cache writes are masked
        blk = torch.where(positions < valid_len[0], bt_row[positions // bs],
                          0)
        offs = positions % bs
        x = params["embed"][ids]
        for lp, pg in zip(params["layers"], pages):
            x, k, v = llama_math.decoder_layer(
                lp, x, positions, eps, base, H, K, d, lengths=valid_len,
                return_kv=True)
            write_rows(pg, blk, offs, k[0], v[0])
        x = llama_math.rms(x, params["norm"], eps)
        last = x[torch.arange(B, device=x.device),
                 (valid_len.long() - 1).clamp(min=0)]
        return F.linear(last, params["head"])

    def decode(params, pages, block_tables, pos, last_logits, generators,
               temps, top_ks, top_ps, active):
        tok = sample_tokens(last_logits, generators, temps, top_ks, top_ps)
        rows = torch.arange(batch_slots, device=pos.device)
        blk = torch.where(active, block_tables[rows, pos // bs], 0)
        offs = torch.where(active, pos % bs, 0)
        vl = torch.where(active, pos + 1, 1).to(torch.int32)
        x = params["embed"][tok][:, None, :]
        for lp, pg in zip(params["layers"], pages):
            q, k, v = llama_math.layer_qkv(lp, x, pos[:, None], eps, base,
                                           H, K, d)
            write_rows(pg, blk, offs, k[:, 0], v[:, 0])
            att = flash_decode_paged(q[:, 0], pg["k"], pg["v"],
                                     block_tables, vl)[:, None]
            x = llama_math.layer_finish(lp, x, att, eps)
        logits = llama_math.final_logits(params, x, eps)[:, 0]
        return tok, logits

    return {"prefill": Program("serving_prefill", prefill),
            "decode": Program("serving_decode", decode)}

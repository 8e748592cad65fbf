"""The generation and serving programs (counterpart of
`mxnet_tpu/serving/executables.py`).

PyTorch runs eagerly, so there is nothing to compile: a `Program` is the
plain function plus a count of its calls, run under inference mode.

Contiguous-cache generation (`models/llama_infer.generate`,
`generate_beam`):

    decoder_programs(net, max_len, kv_cache_dtype) -> {prefill, step}
        `build_decoder`'s prefill and one decode step over per-layer
        (B, K, max_len, d) caches.

    scan_program(dec, mode)(params, cache, logits, pos, finished, eos,
                            temps, top_ks, top_ps, generators, steps)
        -> (cache, logits, pos, finished, tokens (steps, B))
        A chunk of decode steps as a Python loop. Per step: sample from
        the incoming logits (argmax when mode is "greedy"), freeze
        finished rows to eos, step. eos -1 disables it.

Paged serving (`server.InferenceServer`), `paged_programs`:

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

With kv_cache_dtype "int8" the caches and pools hold int8 codes with
per-token fp32 scales ({"k", "ks", "v", "vs"}), written through
`_quant_rows` (quantize_kv's math) and read by the int8 kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_decode import (flash_decode_paged,
                                    flash_decode_paged_quantized,
                                    quantize_rows)
from ..models import llama_math
from .sampling import sample_tokens

__all__ = ["Program", "KV_CACHE_DTYPES", "check_kv_cache_dtype",
           "decoder_programs", "scan_program", "paged_programs",
           "write_rows"]

#: what a KV cache may hold: the model dtype, or int8 codes + fp32 scales
KV_CACHE_DTYPES = ("model", "int8")

#: per-token symmetric int8 over the trailing dim, exactly quantize_kv's
#: math, so the paged int8 server is token-identical to int8 generate()
_quant_rows = quantize_rows


def check_kv_cache_dtype(kv_cache_dtype: str):
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r} not in "
                         f"{KV_CACHE_DTYPES}")


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


def write_rows(pg, idx0, idx1, k_rows, v_rows):
    """Scatter per-token rows (T, K, d) into a cache at (idx0, idx1)
    pairs (T,): (block, offset) in an (N, K, bs, ·) pool, (row, position)
    in a (B, K, S, ·) cache. The JAX package returns a new cache from
    `.at[].set` on a donated buffer; here the write is an in-place
    `index_put_` into the cache itself, through a view with the token
    axis leading. An int8 cache ("ks" in `pg`) takes `_quant_rows` of
    the rows: codes into "k"/"v", scales into "ks"/"vs"."""
    idx = (idx0.long(), idx1.long())
    if "ks" in pg:
        (k_rows, ks), (v_rows, vs) = _quant_rows(k_rows), _quant_rows(v_rows)
        pg["ks"].permute(0, 2, 1, 3).index_put_(idx, ks)
        pg["vs"].permute(0, 2, 1, 3).index_put_(idx, vs)
    pg["k"].permute(0, 2, 1, 3).index_put_(idx, k_rows)
    pg["v"].permute(0, 2, 1, 3).index_put_(idx, v_rows)


# -- contiguous-cache generation ---------------------------------------------

def decoder_programs(net, max_len: int, kv_cache_dtype: str = "model"):
    """Contiguous-cache prefill + step as Programs."""
    from ..models.llama_infer import build_decoder
    _, prefill, step = build_decoder(net, max_len,
                                     kv_cache_dtype=kv_cache_dtype)
    return {"prefill": Program("gen_prefill", prefill),
            "step": Program("gen_step", step)}


def _make_scan(step, mode: str):
    def scan_chunk(params, cache, logits, pos, finished, eos, temps,
                   top_ks, top_ps, generators, steps):
        toks = []
        for _ in range(steps):
            if mode == "sample":
                tok = sample_tokens(logits, generators, temps, top_ks,
                                    top_ps)
            else:
                tok = logits.argmax(dim=-1)
            # finished rows keep emitting eos (and keep stepping: rows
            # are independent, their cache writes are inert)
            tok = torch.where(finished, max(eos, 0), tok)
            if eos >= 0:
                finished = finished | (tok == eos)
            cache, logits = step(params, cache, pos, tok)
            pos = pos + 1
            toks.append(tok)
        return cache, logits, pos, finished, torch.stack(toks)

    return scan_chunk


def scan_program(dec, mode: str):
    """A chunk of `dec`'s decode steps as a Program. mode: 'greedy' |
    'sample'."""
    if mode not in ("greedy", "sample"):
        raise ValueError(f"mode {mode!r} not in ('greedy', 'sample')")
    return Program(f"gen_scan_{mode}", _make_scan(dec["step"], mode))


# -- paged serving -----------------------------------------------------------

def paged_programs(cfg, *, batch_slots: int, block_size: int,
                   kv_cache_dtype: str = "model"):
    """The prefill and decode `Program`s for one model config, pool
    geometry and cache dtype."""
    check_kv_cache_dtype(kv_cache_dtype)
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps, base, bs = cfg.rms_eps, cfg.rope_base, block_size
    q8 = kv_cache_dtype == "int8"

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
            if q8:
                att = flash_decode_paged_quantized(
                    q[:, 0], pg["k"], pg["ks"], pg["v"], pg["vs"],
                    block_tables, vl)
            else:
                att = flash_decode_paged(q[:, 0], pg["k"], pg["v"],
                                         block_tables, vl)
            x = llama_math.layer_finish(lp, x, att[:, None], eps)
        logits = llama_math.final_logits(params, x, eps)[:, 0]
        return tok, logits

    return {"prefill": Program("serving_prefill", prefill),
            "decode": Program("serving_decode", decode)}

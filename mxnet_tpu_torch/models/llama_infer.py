"""Autoregressive decoding with a contiguous KV cache for the Llama
decoder (counterpart of `mxnet_tpu/models/llama_infer.py`).

One prefill (the prompt forward, which fills the cache) and then one
decode step per new token. The cache is allocated at `max_len` up front
in the cache-native layout (B, K, max_len, d), kv-head major, which the
decode kernels read without a per-step transpose. Greedy, or per-row
temperature/top-k/top-p sampling; `eos_id` freezes finished rows; beam
search over the same step.

    net = get_model("llama_3_8b")                 # on cuda
    out = generate(net, prompt_ids, max_new_tokens=32, temperature=0.8)

Sampling streams: row r of a call with `seed` s draws from its own
`torch.Generator`, seeded with `numpy.random.SeedSequence([s, r])`. The
JAX package splits `PRNGKey(seed)` per step instead, so sampled tokens
differ between the packages by design; greedy tokens and the kept
top-k/top-p sets agree.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..context import check_weights_on, resolve_device
from . import llama_math

__all__ = ["generate", "generate_beam", "build_decoder", "_params_tree"]


def _params_tree(net):
    """The decoder weights as a plain dict keyed by role. The tensors are
    the module's own (detached views), so later weight loads show
    through without a refresh."""
    cfg = net.model.cfg
    ps = {n: p.detach() for n, p in net.named_parameters()}
    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        layers.append({
            "ln1": ps[pre + "input_layernorm.gamma"],
            "wq": ps[pre + "self_attn.q_proj.weight"],
            "wk": ps[pre + "self_attn.k_proj.weight"],
            "wv": ps[pre + "self_attn.v_proj.weight"],
            "wo": ps[pre + "self_attn.o_proj.weight"],
            "ln2": ps[pre + "post_attention_layernorm.gamma"],
            "gate": ps[pre + "mlp.gate_proj.weight"],
            "up": ps[pre + "mlp.up_proj.weight"],
            "down": ps[pre + "mlp.down_proj.weight"],
        })
    return {"embed": ps["model.embed_tokens.weight"],
            "norm": ps["model.norm.gamma"],
            "head": ps["lm_head.weight"],
            "layers": layers}


def _attend(q, k_cache, v_cache, valid_len, cfg):
    """q (B, 1, H, d) against (B, K, S, d) caches, keys [0, valid_len):
    the decode kernel. Only the single-position route is ported: the
    decode step is the only caller."""
    if q.shape[1] != 1:
        raise ValueError(f"q has {q.shape[1]} positions; the decode step "
                         "attends one")
    from ..kernels.flash_decode import flash_decode
    return flash_decode(q[:, 0], k_cache, v_cache, valid_len,
                        scale=1.0 / math.sqrt(cfg.head_dim))[:, None]


def build_decoder(net, max_len: int, kv_cache_dtype: str = "model"):
    """Returns (params, prefill, step).

    prefill(params, ids (B, T), valid_len (B,) int32) -> (cache,
    last_logits (B, V)): runs the prompt (right-padded) and fills the
    cache, padding rows included (valid_len masks them, and the steps
    overwrite them from valid_len on).
    step(params, cache, pos (B,), tok (B,)) -> (cache, logits (B, V)):
    one decode step for `tok` at absolute position `pos`; the new k/v
    rows are written into the cache in place.
    cache: per layer {k, v} of (B, K, max_len, d), or with
    kv_cache_dtype="int8" int8 {k, v} plus fp32 per-token scales
    {ks, vs} (B, K, max_len, 1), read by the int8 decode kernel."""
    from ..kernels.flash_decode import flash_decode_quantized, quantize_kv
    from ..serving.executables import check_kv_cache_dtype, write_rows
    check_kv_cache_dtype(kv_cache_dtype)
    cfg = net.model.cfg
    params = _params_tree(net)
    q8 = kv_cache_dtype == "int8"
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps, base = cfg.rms_eps, cfg.rope_base

    def prefill(params, ids, valid_len):
        B, T = ids.shape
        x = params["embed"][ids]
        positions = torch.arange(T, device=ids.device)
        cache = []
        for lp in params["layers"]:
            x, k, v = llama_math.decoder_layer(
                lp, x, positions, eps, base, H, K, d, lengths=valid_len,
                return_kv=True)
            k_c = x.new_zeros(B, K, max_len, d)
            v_c = x.new_zeros(B, K, max_len, d)
            k_c[:, :, :T] = k.transpose(1, 2)
            v_c[:, :, :T] = v.transpose(1, 2)
            if q8:
                cache.append(dict(zip(("k", "ks", "v", "vs"),
                                      quantize_kv(k_c, v_c))))
            else:
                cache.append({"k": k_c, "v": v_c})
        x = llama_math.rms(x, params["norm"], eps)
        last = x[torch.arange(B, device=x.device),
                 (valid_len.long() - 1).clamp(min=0)]
        return cache, F.linear(last, params["head"])

    def step(params, cache, pos, tok):
        rows = torch.arange(tok.shape[0], device=tok.device)
        vl = (pos + 1).to(torch.int32)
        x = params["embed"][tok][:, None, :]              # (B, 1, D)
        for lp, c in zip(params["layers"], cache):
            q, k, v = llama_math.layer_qkv(lp, x, pos[:, None], eps, base,
                                           H, K, d)
            write_rows(c, rows, pos, k[:, 0], v[:, 0])
            if q8:
                att = flash_decode_quantized(q[:, 0], c["k"], c["ks"],
                                             c["v"], c["vs"], vl)[:, None]
            else:
                att = _attend(q, c["k"], c["v"], vl, cfg)
            x = llama_math.layer_finish(lp, x, att, eps)
        return cache, llama_math.final_logits(params, x, eps)[:, 0]

    return params, prefill, step


def _row_generators(seed: int, n: int, device):
    return [torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, r]).generate_state(1, np.uint64)[0]))
        for r in range(n)]


def _prompt(net, prompt_ids, device):
    dev = resolve_device(device)
    check_weights_on(net, dev)
    ids = torch.as_tensor(prompt_ids).to(dev, torch.int64)
    if ids.dim() != 2:
        raise ValueError(f"prompt_ids has shape {tuple(ids.shape)}; "
                         "expected (B, T)")
    return dev, ids


@torch.inference_mode()
def generate(net, prompt_ids, max_new_tokens: int, temperature=0.0,
             top_k=0, top_p=0.0, seed: int = 0,
             max_len: Optional[int] = None, kv_cache_dtype: str = "model",
             valid_len=None, eos_id: Optional[int] = None,
             return_finished: bool = False, device=None):
    """Autoregressive generation. prompt_ids: (B, T) ints. Ragged
    prompts: right-pad shorter rows with any token and pass per-row true
    lengths as `valid_len` (B,); each row's continuation starts at its
    own length. Generated tokens occupy columns [T, T + max_new_tokens)
    of the output regardless of the row's valid length.

    temperature 0 = greedy; top_k keeps the k best logits; top_p keeps
    the smallest nucleus whose mass reaches p (both compose with
    temperature). Scalars broadcast, or pass (B,) arrays for per-row
    sampling params.

    eos_id: rows freeze after emitting eos (remaining columns filled
    with eos) and decoding runs in chunks of 8 steps, so a batch whose
    rows have all finished stops early. return_finished=True also
    returns (B,) finish positions: the index of eos within the
    generated tokens, or -1.

    `device` defaults to `cuda`; the net's weights must live there.
    Returns (B, T + max_new_tokens) int32 numpy."""
    from ..serving import executables as _exe
    dev, ids = _prompt(net, prompt_ids, device)
    B, T = ids.shape
    cfg = net.model.cfg
    if valid_len is None:
        vl = np.full(B, T, np.int32)
    else:
        vl = np.asarray(valid_len, np.int32).reshape(B)
        if not ((vl >= 1) & (vl <= T)).all():
            raise ValueError("valid_len entries must lie in [1, T]")
    valid = torch.from_numpy(vl).to(dev)

    greedy = temperature is None or (
        np.ndim(temperature) == 0 and float(temperature) <= 0.0)
    mode = "greedy" if greedy else "sample"

    # with an eos the steps run CHUNK at a time so a finished batch
    # exits early; without one a single full-length chunk
    chunk = max_new_tokens if eos_id is None else min(8, max_new_tokens)
    n_chunks = -(-max_new_tokens // chunk)
    padded_new = n_chunks * chunk
    cap = max_len or cfg.max_seq_len
    if T + padded_new > cap:          # cap hit: one exact-size chunk
        chunk, n_chunks, padded_new = max_new_tokens, 1, max_new_tokens
    if max_len is None:
        max_len = min(cfg.max_seq_len, T + padded_new)
    if T + max_new_tokens > max_len:
        raise ValueError(f"max_len={max_len} is too small for {T} prompt "
                         f"+ {max_new_tokens} new tokens")

    dec = _exe.decoder_programs(net, max_len, kv_cache_dtype)
    scan = _exe.scan_program(dec, mode)
    params = _params_tree(net)
    cache, logits = dec["prefill"](params, ids, valid)

    def as_vec(v, dt):
        v = np.broadcast_to(np.asarray(0 if v is None else v), (B,))
        return torch.tensor(v.copy(), dtype=dt, device=dev)
    temps = as_vec(temperature, torch.float32)
    ks = as_vec(top_k, torch.int64)
    ps = as_vec(top_p, torch.float32)
    eos = -1 if eos_id is None else int(eos_id)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    pos = valid.long()
    gens = _row_generators(seed, B, dev) if mode == "sample" else None

    pieces = []
    emitted = 0
    for _ in range(n_chunks):
        cache, logits, pos, finished, toks = scan(
            params, cache, logits, pos, finished, eos, temps, ks, ps, gens,
            chunk)
        pieces.append(toks.cpu().numpy())              # (chunk, B)
        emitted += chunk
        if eos_id is not None and emitted < padded_new \
                and bool(finished.all()):
            # every row froze: the remaining steps would only emit eos
            pieces.append(np.full((padded_new - emitted, B), eos_id))
            break

    toks = np.concatenate(pieces, axis=0)[:max_new_tokens]
    out = np.concatenate([ids.cpu().numpy(), toks.T], axis=1) \
        .astype(np.int32)
    if not return_finished:
        return out
    gen = out[:, T:]
    if eos_id is None:
        finish_pos = np.full((B,), -1, np.int64)
    else:
        hit = gen == eos_id
        finish_pos = np.where(hit.any(axis=1), hit.argmax(axis=1), -1)
    return out, finish_pos


@torch.inference_mode()
def generate_beam(net, prompt_ids, max_new_tokens: int, beam_size=4,
                  eos_id: Optional[int] = None, length_penalty=1.0,
                  max_len: Optional[int] = None,
                  kv_cache_dtype: str = "model", device=None):
    """Beam-search decoding over the cached decoder. The B*W rows ride
    the same step as generate(); beam bookkeeping is a top-k over
    (B, W*V), and finished beams are frozen by forcing eos at log-prob 0.
    Every step gathers the whole cache to the surviving beams' parents,
    as the JAX package does. Returns (B, T + max_new_tokens) int32 numpy:
    the best beam per batch row under score / len**length_penalty."""
    from ..serving import executables as _exe
    from .beam_search import beam_expand_topk
    dev, ids = _prompt(net, prompt_ids, device)
    B, T = ids.shape
    W = beam_size
    cfg = net.model.cfg
    max_len = max_len or min(cfg.max_seq_len, T + max_new_tokens)
    if T + max_new_tokens > max_len:
        raise ValueError(f"max_len={max_len} is too small for {T} prompt "
                         f"+ {max_new_tokens} new tokens")
    dec = _exe.decoder_programs(net, max_len, kv_cache_dtype)
    params = _params_tree(net)
    valid = torch.full((B,), T, dtype=torch.int32, device=dev)
    cache, logits = dec["prefill"](params, ids, valid)

    # expand every batch row to W beams (contiguous blocks of W)
    cache = [{f: t.repeat_interleave(W, dim=0) for f, t in c.items()}
             for c in cache]
    logits = logits.repeat_interleave(W, dim=0)           # (B*W, V)
    V = logits.shape[-1]
    pos = valid.long().repeat_interleave(W)               # (B*W,)
    # only beam 0 is live initially, so the first top-k is not W copies
    # of the same candidate
    scores = torch.full((B, W), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.int64, device=dev)
    toks = torch.zeros((B, W, max_new_tokens), dtype=torch.int64,
                       device=dev)
    base = torch.arange(B, device=dev)[:, None] * W

    for t in range(max_new_tokens):
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
        was_finished = finished
        scores, src, tok, finished = beam_expand_topk(scores, logp,
                                                      finished, eos_id)
        toks = toks.gather(1, src[..., None].expand(-1, -1, max_new_tokens))
        toks[:, :, t] = tok
        lengths = lengths.gather(1, src)
        lengths = torch.where(was_finished.gather(1, src), lengths,
                              lengths + 1)
        if eos_id is not None and bool(finished.all()):
            # remaining positions: eos padding, as the frozen beams
            # would have continued
            toks[:, :, t + 1:] = eos_id
            break
        if t < max_new_tokens - 1:      # the last selection needs no logits
            gather = (base + src).reshape(-1)
            cache = [{f: x[gather] for f, x in c.items()} for c in cache]
            pos = pos[gather]
            cache, logits = dec["step"](params, cache, pos, tok.reshape(-1))
            pos = pos + 1

    norm = lengths.clamp(min=1).float() ** length_penalty
    best = (scores / norm).argmax(dim=1)                  # (B,)
    best_toks = toks[torch.arange(B, device=dev), best]   # (B, max_new)
    return torch.cat([ids, best_toks], dim=1).cpu().numpy().astype(np.int32)

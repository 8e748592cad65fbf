#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`mxnet_tpu_torch`).

    python3 chip_smoke.py          # one CUDA card, nvcc on PATH or CUDA_HOME

Phases, each printing its lines before the next starts; any failure
exits non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi), then the build
   of every kernel from `mxnet_tpu_torch/csrc` (nvcc, sm_90a).
2. kernels: each CUDA kernel against its plain PyTorch version at the
   serving and generation paths' own shapes (bf16) plus ragged cases,
   every element within its own stated tolerance; at the main shapes,
   attention made off by one at the key length or the diagonal must fall
   outside it; kernel, plain and library (yardstick only: the port never
   calls it) times with a cold L2, and the least time the card could
   take for the same work. The int8 decode kernels read caches quantized
   from rows whose magnitudes vary by token.
3. serve: Llama-3-8B at full width (vocab 32000, D 4096, I 14336, 32
   layers, 32 heads / 8 kv heads, bf16; random weights from a seed)
   behind `InferenceServer(batch_slots=8, block_size=16, max_len=2048,
   max_prompt_len=512)`: 16 requests of 33-512 prompt tokens, 32 new
   tokens each, greedy plus top-k/top-p rows. Every kernel's launch
   count over that run must equal its expected count (RMSNorm 65 per
   forward, prefill 32 per request, decode 32 per tick, 0 for the
   others); request 0's prefill is re-run with the plain versions and
   the last-position logits compared. Then a steady decode tick's wall
   time and the card's busy time in it, by kernel family
   (torch.profiler). Then the same 16 requests through a server with
   an int8 pool (`kv_cache_dtype="int8"`): the int8 paged kernel 32
   times per tick, the bf16 one never, each greedy request's first token
   equal to the bf16 server's.
4. generate: `generate()` on the same net, 8 prompts right-padded to
   512 (valid_len 33-512), 32 greedy tokens, with a bf16 and with an
   int8 cache: exact launch counts (contiguous decode 32 per step), the
   same first token in every row, and 32 teacher-forced steps of both
   caches within max(2%, twice the bf16 path's own deviation from an
   fp32 copy of the net) relative logit difference; then `generate_beam` on
   two prompts (beam_size 4, 8 new tokens). Tokens/s of each run.
5. the kernels line (JSON), the card line, and the result line
   `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH_SLOTS, BLOCK_SIZE, MAX_LEN, MAX_PROMPT = 8, 16, 2048, 512
N_REQUESTS, NEW_TOKENS = 16, 32

# H100 SXM, NVIDIA data sheet (dense): HBM3 3.35 TB/s; bf16 tensor cores
# 989 TFLOP/s; fp32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, ops, kind):
    """(ms, "bytes"|"operations"): the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def cold_ms(torch, fn, flush, reps=20):
    """Median per-call device time with L2 flushed before each call (a
    64 MB write): the serving path meets each layer's weights and KV
    cold. A spin of about 1 ms on the card before the start event lets
    the host enqueue the whole call first, so the events time the
    device's work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    evs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def max_err(out, ref):
    return float((out.float() - ref.float()).abs().max())


# Element-wise tolerances, each term with its reason:
# - BF16_STEP: bf16 keeps 8 significant bits, so two fp32 results that
#   agree to fp32 noise round to the same or to adjacent bf16 values, and
#   adjacent values differ by at most 2^-7 of either: one step of |ref|.
# - BF16_ROUND: rounding a value to bf16 moves it by at most 2^-8 of it.
# - FP32_NOISE: two fp32 computations of one attention row (another sum
#   order over d products per score and over the keys, another exp)
#   differ by far less than 2^-14 of the row's sum of p * |v|.
BF16_STEP, BF16_ROUND, FP32_NOISE = 2.0 ** -7, 2.0 ** -8, 2.0 ** -14


def held(torch, label, out, ref, tol):
    """Every element within its own tolerance: |out - ref| <= tol.
    Returns (max_abs_err, text)."""
    diff = (out.float() - ref.float()).abs()
    over = int((diff > tol).sum())
    err = float(diff.max())
    check(bool(torch.isfinite(out).all()) and over == 0,
          f"{label}: {over} elements beyond their tolerance "
          f"(max_abs_err {err}, largest excess "
          f"{float((diff - tol).max())})")
    return err, f"max_abs_err={err:.3g}, every element within tol " \
                f"(largest tol {float(tol.max()):.3g})"


def caught(torch, label, wrong, ref, tol):
    """A kernel with an off-by-one mask would have failed `held`: some
    element of its output lies beyond its tolerance."""
    over = int(((wrong.float() - ref.float()).abs() > tol).sum())
    check(over > 0, f"{label}: an off-by-one output passes the tolerance")
    return f"{label} caught ({over} elements over tol)"


def attn_probs(torch, q, k, scale, lengths, causal, diag=0):
    """fp32 softmax probabilities (B, H, T, S) of q (B, T, H, d) over
    k (B, S, K, d): key s is kept where s < lengths[b] and, if causal,
    s <= t + diag; a row with no kept key is all 0."""
    B, T, H, _ = q.shape
    S, K = k.shape[1], k.shape[2]
    s = torch.einsum("bthd,bshd->bhts", q.float(),
                     k.float().repeat_interleave(H // K, dim=2)) * scale
    j = torch.arange(S, device=q.device)
    keep = (j[None, :] < lengths[:, None].long())[:, None, None, :]
    if causal:
        t = torch.arange(T, device=q.device)
        keep = keep & (j[None, :] <= t[:, None] + diag)[None, None]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.where(keep.any(dim=-1, keepdim=True), p, 0.0)


def attn_apply(torch, p, v, H):
    """(B, T, H, d) fp32: probabilities (B, H, T, S) applied to v
    (B, S, K, d), and to |v| (the scale of the row's rounding terms)."""
    vf = v.float().repeat_interleave(H // v.shape[2], dim=2)
    return (torch.einsum("bhts,bshd->bthd", p, vf),
            torch.einsum("bhts,bshd->bthd", p, vf.abs()))


def decode_probs(torch, q, k_cache, valid_len, scale):
    """fp32 probabilities (B, K, rep, S) of q (B, H, d) over a gathered
    (B, K, S, d) cache, keys masked at valid_len; an empty row is 0."""
    B, H, d = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    s = torch.einsum("bkrd,bksd->bkrs", q.reshape(B, K, H // K, d).float(),
                     k_cache.float()) * scale
    keep = (torch.arange(S, device=q.device)[None, :]
            < valid_len[:, None].long())[:, None, None, :]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.where(keep.any(dim=-1, keepdim=True), p, 0.0)


def decode_apply(torch, p, v_cache):
    """(B, H, d) fp32: probabilities applied to the cache and to |v|."""
    B, K, rep, _ = p.shape
    vf = v_cache.float()
    return tuple(torch.einsum("bkrs,bksd->bkrd", p, w).reshape(B, K * rep, -1)
                 for w in (vf, vf.abs()))


# -- phase 2: kernels against their plain versions --------------------------

def kernel_rmsnorm(torch, F, flush):
    from mxnet_tpu_torch.kernels.fused_norm import rmsnorm, rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    eps = 1e-5
    entry = None
    for label, (n, d), dtype in (("prefill", (MAX_PROMPT, 4096), torch.bfloat16),
                                 ("decode", (BATCH_SLOTS, 4096), torch.bfloat16),
                                 ("ragged", (333, 4096), torch.bfloat16),
                                 ("narrow fp32", (37, 64), torch.float32)):
        x = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
        g = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        out, ref = rmsnorm(x, g, eps), rmsnorm_ref(x, g, eps)
        torch.cuda.synchronize()
        # both compute x * rrms * gamma in fp32 and differ only in the sum
        # order of the statistics (a few fp32 steps, under 2^-19
        # relative): one bf16 step of |ref|, or 2^-19 of it in fp32
        rtol = BF16_STEP if dtype == torch.bfloat16 else 2.0 ** -19
        err, text = held(torch, f"rmsnorm {label}", out, ref,
                         rtol * ref.float().abs())
        line = f"[kernels] rmsnorm {label} {tuple(x.shape)} {dtype}: " \
               f"{text}, rtol {rtol:.3g}"
        if label in ("prefill", "decode"):
            ms = cold_ms(torch, lambda: rmsnorm(x, g, eps), flush)
            plain = cold_ms(torch, lambda: rmsnorm_ref(x, g, eps), flush)
            gx = g.to(dtype)
            lib = cold_ms(torch, lambda: F.rms_norm(x, (d,), gx, eps), flush)
            b_ms, b_by = bound(2 * x.numel() * x.element_size() + d * 4,
                               4 * x.numel(), "fp32")
            line += f" ms={ms:.4f} plain_ms={plain:.4f} library_ms=" \
                    f"{lib:.4f} bound_ms={b_ms:.4f} ({b_by})"
            if label == "prefill":
                entry = dict(name="rmsnorm", max_abs_err=err, ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                             bound_by=b_by, shape=f"x {tuple(x.shape)} bf16")
        print(line, flush=True)
    return entry


def kernel_flash_prefill(torch, F, flush, main_len):
    from mxnet_tpu_torch.kernels.flash_attention import (
        flash_attention_forward, reference_attention)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    entry = None
    cases = (("main", 1, MAX_PROMPT, 32, 8, 128, [main_len], torch.bfloat16),
             ("ragged", 2, 333, 32, 8, 128, [333, 150], torch.bfloat16),
             ("tiny fp32", 3, 77, 4, 2, 16, [77, 40, 0], torch.float32))
    for label, B, T, H, K, d, lens, dtype in cases:
        q = torch.randn(B, T, H, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, T, K, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, T, K, d, generator=gen, device="cuda").to(dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = 1.0 / math.sqrt(d)
        out = flash_attention_forward(q, k, v, True, scale, lengths)
        ref = reference_attention(q, k, v, True, scale, lengths)
        torch.cuda.synchronize()
        # the plain version rounds P to bf16 before P @ V, as the JAX
        # reference does (one rounding of each p: 2^-8 of the row's sum
        # of p * |v|), the kernel keeps P in fp32, and each rounds its
        # output once (one bf16 step of |ref|); fp32 differs by noise
        _, pv_abs = attn_apply(torch, attn_probs(torch, q, k, scale,
                                                 lengths, True), v, H)
        if dtype == torch.bfloat16:
            tol = BF16_STEP * ref.float().abs() \
                + (BF16_ROUND + FP32_NOISE) * pv_abs
        else:
            tol = FP32_NOISE * pv_abs
        err, text = held(torch, f"flash_prefill {label}", out, ref, tol)
        line = f"[kernels] flash_prefill {label} B={B} T={T} H={H} K={K} " \
               f"d={d} lengths={lens} {dtype}: {text}"
        if label == "main":
            # a kernel off by one at the key length or at the diagonal
            # would fail the same tolerance
            wrongs = [("lengths-1", lengths - 1, 0),
                      ("diagonal-1", lengths, -1),
                      ("diagonal+1", lengths, 1)]
            if lens[0] < T:
                wrongs.append(("lengths+1", lengths + 1, 0))
            line += "; off by one: " + ", ".join(
                caught(torch, f"flash_prefill {name}",
                       attn_apply(torch, attn_probs(torch, q, k, scale, ln,
                                                    True, dg), v, H)[0]
                       .to(dtype), ref, tol)
                for name, ln, dg in wrongs)
            ms = cold_ms(torch, lambda: flash_attention_forward(
                q, k, v, True, scale, lengths), flush, reps=10)
            plain = cold_ms(torch, lambda: reference_attention(
                q, k, v, True, scale, lengths), flush, reps=10)
            L = lens[0]
            t = torch.arange(T, device="cuda")
            mask = (t[None, :] <= t[:, None]) & (t[None, :] < L)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), flush, reps=10)
            # this run's work: each query row t attends min(t + 1, L)
            # keys; K/V rows past L are never needed
            pairs = sum(min(i + 1, L) for i in range(T))
            nbytes = (2 * q.numel() + 2 * B * L * K * d) * q.element_size()
            b_ms, b_by = bound(nbytes, pairs * H * 4 * d, "bf16")
            line += f" ms={ms:.4f} plain_ms={plain:.4f} library_ms=" \
                    f"{lib:.4f} bound_ms={b_ms:.4f} ({b_by})"
            entry = dict(name="flash_prefill", max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by,
                         shape=f"B=1 T={T} H=32 K=8 d=128 length={L} bf16")
        print(line, flush=True)
    return entry


def kernel_paged_decode(torch, F, flush):
    from mxnet_tpu_torch.kernels.flash_decode import (
        flash_decode_paged, gather_kv_pages, reference_paged_decode)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rs = np.random.RandomState(SEED + 2)
    entry = None
    main_vl = rs.randint(33, MAX_PROMPT + NEW_TOKENS + 1, BATCH_SLOTS)
    cases = (("main", 32, 8, 128, BLOCK_SIZE, MAX_LEN, main_vl,
              torch.bfloat16),
             ("block 8", 32, 8, 128, 8, 256, [1, 77, 256], torch.bfloat16),
             ("tiny fp32", 4, 2, 16, 8, 64, [1, 13, 64], torch.float32))
    for label, H, K, d, bs, max_len, vls, dtype in cases:
        B, nb = len(vls), max_len // bs
        N = B * nb + 1
        q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
        kp = torch.randn(N, K, bs, d, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(N, K, bs, d, generator=gen, device="cuda").to(dtype)
        # shuffled physical blocks; entries past valid_len stay at the
        # scratch block 0
        bt = np.zeros((B, nb), np.int32)
        ids = 1 + rs.permutation(N - 1)
        for b, vl in enumerate(vls):
            nblk = -(-int(vl) // bs)
            bt[b, :nblk] = ids[b * nb:b * nb + nblk]
        bt_t = torch.from_numpy(bt).cuda()
        vl_t = torch.tensor(np.asarray(vls, np.int32)).cuda()
        scale = 1.0 / math.sqrt(d)
        out = flash_decode_paged(q, kp, vp, bt_t, vl_t, scale)
        ref = reference_paged_decode(q, kp, vp, bt_t, vl_t, scale)
        torch.cuda.synchronize()
        # the plain version works in fp32 throughout: both round the
        # output once (one bf16 step of |ref|) or differ by fp32 noise
        kc, vc = gather_kv_pages(kp, bt_t), gather_kv_pages(vp, bt_t)
        _, pv_abs = decode_apply(torch, decode_probs(torch, q, kc, vl_t,
                                                     scale), vc)
        tol = FP32_NOISE * pv_abs
        if dtype == torch.bfloat16:
            tol = tol + BF16_STEP * ref.float().abs()
        err, text = held(torch, f"paged_decode {label}", out, ref, tol)
        line = f"[kernels] paged_decode {label} B={B} H={H} K={K} d={d} " \
               f"bs={bs} valid_len={list(map(int, vls))} {dtype}: {text}"
        if label == "main":
            # a kernel that stops one token early or reads one too many
            # (past valid_len, into the rest of the block or block 0)
            # would fail the same tolerance
            line += "; off by one: " + ", ".join(
                caught(torch, f"paged_decode {name}",
                       decode_apply(torch, decode_probs(
                           torch, q, kc, vl_t + dv, scale), vc)[0]
                       .to(dtype), ref, tol)
                for name, dv in (("valid_len-1", -1), ("valid_len+1", 1)))
            ms = cold_ms(torch, lambda: flash_decode_paged(
                q, kp, vp, bt_t, vl_t, scale), flush)
            plain = cold_ms(torch, lambda: reference_paged_decode(
                q, kp, vp, bt_t, vl_t, scale), flush)
            S = kc.shape[2]
            mask = (torch.arange(S, device="cuda")[None, :]
                    < vl_t[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kc, vc, attn_mask=mask, enable_gqa=True), flush)
            tokens = int(np.sum(vls))
            nbytes = (2 * q.numel() + 2 * tokens * K * d) * q.element_size() \
                + bt.nbytes + 4 * B
            b_ms, b_by = bound(nbytes, tokens * H * 4 * d, "bf16")
            line += f" ms={ms:.4f} plain_ms={plain:.4f} library_ms=" \
                    f"{lib:.4f} bound_ms={b_ms:.4f} ({b_by})"
            entry = dict(name="paged_decode", max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by,
                         shape=f"B=8 H=32 K=8 d=128 bs=16 "
                               f"sum(valid_len)={tokens} bf16")
        print(line, flush=True)
    return entry


#: the decode kernels of slice 2: (paged, int8 cache)
DECODE_KERNELS = {"contig_decode": (False, False),
                  "contig_decode_q8": (False, True),
                  "paged_decode_q8": (True, True)}


def cache_rows(torch, gen, shape, dtype, spread):
    """Normal rows, each token's row scaled by e^(spread z): per-token
    magnitudes (and so int8 scales) that differ by orders."""
    mag = torch.exp(spread * torch.randn(*shape[:-1], 1, generator=gen,
                                         device="cuda"))
    return (torch.randn(*shape, generator=gen, device="cuda") * mag).to(dtype)


def kernel_decode(torch, F, flush, name):
    """One of the slice-2 decode kernels against its plain version: the
    contiguous (B, K, S, d) cache at generate()'s shapes (8 prompts of up
    to 512 tokens + 32 new), or the served int8 pool geometry (bs 16,
    max_len 2048, shuffled tables). int8 caches come from quantize_kv of
    bf16 rows whose magnitudes vary by token (k over e^0.5, v over e^1.5),
    so the per-token scales, which fold into the scores (k) and into p
    before P.V (v) but not into the running sum, differ by orders."""
    from mxnet_tpu_torch.kernels import flash_decode as fd
    paged, q8 = DECODE_KERNELS[name]
    kern, plain = {
        "contig_decode": (fd.flash_decode, fd.reference_decode_attention),
        "contig_decode_q8": (fd.flash_decode_quantized,
                             fd.reference_decode_quantized),
        "paged_decode_q8": (fd.flash_decode_paged_quantized,
                            fd.reference_paged_decode_quantized)}[name]
    seed = SEED + 3 + list(DECODE_KERNELS).index(name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rs = np.random.RandomState(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    if paged:
        main_vl = rs.randint(33, MAX_PROMPT + NEW_TOKENS + 1, BATCH_SLOTS)
        cases = (("main", 32, 8, 128, BLOCK_SIZE, MAX_LEN, main_vl, bf16),
                 ("block 8", 32, 8, 128, 8, 256, [1, 77, 256], bf16),
                 ("tiny fp32", 4, 2, 16, 8, 64, [1, 13, 64], f32))
    else:
        S = MAX_PROMPT + NEW_TOKENS
        main_vl = rs.randint(33, S + 1, BATCH_SLOTS)
        cases = (("main", 32, 8, 128, None, S, main_vl, bf16),
                 ("ragged", 32, 8, 128, None, 333, [1, 200, 333], bf16),
                 ("tiny fp32", 4, 2, 16, None, 77, [1, 13, 77], f32))
    entry = None
    for label, H, K, d, bs, S, vls, dtype in cases:
        B = len(vls)
        q = torch.randn(B, H, d, generator=gen, device="cuda").to(dtype)
        shape = (B * (S // bs) + 1, K, bs, d) if paged else (B, K, S, d)
        k = cache_rows(torch, gen, shape, dtype, 0.5)
        v = cache_rows(torch, gen, shape, dtype, 1.5)
        vl_t = torch.tensor(np.asarray(vls, np.int32)).cuda()
        tables = ()
        if paged:
            # shuffled physical blocks; entries past valid_len stay at
            # the scratch block 0
            nb = S // bs
            bt = np.zeros((B, nb), np.int32)
            ids = 1 + rs.permutation(shape[0] - 1)
            for b, vl in enumerate(vls):
                nblk = -(-int(vl) // bs)
                bt[b, :nblk] = ids[b * nb:b * nb + nblk]
            tables = (torch.from_numpy(bt).cuda(),)
        if q8:
            ops = fd.quantize_kv(k, v)
            kd, vd = (fd.dequantize_kv(ops[i], ops[i + 1], f32)
                      for i in (0, 2))
        else:
            ops, (kd, vd) = (k, v), (k, v)
        if paged:
            kd, vd = (fd.gather_kv_pages(t, tables[0]) for t in (kd, vd))
        scale = 1.0 / math.sqrt(d)
        args = ops + tables + (vl_t, scale)
        out, ref = kern(q, *args), plain(q, *args)
        torch.cuda.synchronize()
        # the plain version dequantizes to fp32 and works in fp32
        # throughout: both round the output once (one bf16 step of |ref|)
        # or differ by fp32 noise of the row's sum of p * |v| (v
        # dequantized)
        _, pv_abs = decode_apply(torch, decode_probs(torch, q, kd, vl_t,
                                                     scale), vd)
        tol = FP32_NOISE * pv_abs
        if dtype == bf16:
            tol = tol + BF16_STEP * ref.float().abs()
        err, text = held(torch, f"{name} {label}", out, ref, tol)
        line = f"[kernels] {name} {label} B={B} H={H} K={K} d={d} " \
               f"{f'bs={bs} max_len' if paged else 'S'}={S} " \
               f"valid_len={list(map(int, vls))} {dtype}: {text}"
        if label == "main":
            # a kernel that stops one token early or reads one too many
            # would fail the same tolerance
            line += "; off by one: " + ", ".join(
                caught(torch, f"{name} {wrong}",
                       decode_apply(torch, decode_probs(
                           torch, q, kd, vl_t + dv, scale), vd)[0]
                       .to(dtype), ref, tol)
                for wrong, dv in (("valid_len-1", -1), ("valid_len+1", 1)))
            ms = cold_ms(torch, lambda: kern(q, *args), flush)
            plain_ms = cold_ms(torch, lambda: plain(q, *args), flush)
            # yardstick: SDPA over the (gathered, dequantized) cache in
            # the model dtype; the gather and the dequantize are not timed
            kl, vl_ = kd.to(dtype), vd.to(dtype)
            mask = (torch.arange(kl.shape[2], device="cuda")[None, :]
                    < vl_t[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kl, vl_, attn_mask=mask, enable_gqa=True), flush)
            tokens = int(np.sum(vls))
            # each valid token's k and v rows once (int8: codes plus one
            # fp32 scale each), q read and out written once, the table
            # and valid_len
            row = 2 * (d + 4) if q8 else 2 * d * q.element_size()
            nbytes = tokens * K * row + 2 * q.numel() * q.element_size() \
                + sum(t.numel() * 4 for t in tables) + 4 * B
            b_ms, b_by = bound(nbytes, tokens * H * 4 * d, "bf16")
            line += f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=" \
                    f"{lib:.4f} (SDPA over the " \
                    f"{'gathered, ' if paged else ''}" \
                    f"{'dequantized ' if q8 else ''}cache; " \
                    f"{'gather and dequantize ' if q8 else ''}not timed) " \
                    f"bound_ms={b_ms:.4f} ({b_by})"
            entry = dict(name=name, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by,
                         shape=f"B=8 H=32 K=8 d=128 "
                               f"{'bs=16 ' if paged else f'S={S} '}"
                               f"sum(valid_len)={tokens} bf16"
                               f"{' q, int8 cache' if q8 else ''}")
        print(line, flush=True)
    return entry


# -- phase 3: serve ------------------------------------------------------------

def plain_prefill_logits(torch, F, net, prompt, dtype):
    """Last-position logits of an unpadded prompt through the plain
    versions of every kernel, computing in `dtype` (weight matrices cast
    layer by layer; the fp32 run is the truth both bf16 paths are
    measured against)."""
    from mxnet_tpu_torch.kernels.flash_attention import reference_attention
    from mxnet_tpu_torch.kernels.fused_norm import rmsnorm_ref
    from mxnet_tpu_torch.models.llama_infer import _params_tree
    from mxnet_tpu_torch.models.llama_math import rope_at, swiglu
    cfg = net.cfg
    p = _params_tree(net)
    H, K, d, eps = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.rms_eps
    ids = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
    T = ids.shape[1]
    pos = torch.arange(T, device="cuda")
    x = p["embed"][ids].to(dtype)
    for lp in p["layers"]:
        lp = {n: t if n in ("ln1", "ln2") else t.to(dtype)
              for n, t in lp.items()}
        h = rmsnorm_ref(x, lp["ln1"], eps)
        q = rope_at(F.linear(h, lp["wq"]).reshape(1, T, H, d), pos,
                    cfg.rope_base)
        k = rope_at(F.linear(h, lp["wk"]).reshape(1, T, K, d), pos,
                    cfg.rope_base)
        v = F.linear(h, lp["wv"]).reshape(1, T, K, d)
        att = reference_attention(q, k, v, True, 1.0 / math.sqrt(d))
        x = x + F.linear(att.reshape(1, T, -1), lp["wo"])
        x = x + swiglu(rmsnorm_ref(x, lp["ln2"], eps), lp["gate"],
                       lp["up"], lp["down"])
    return F.linear(rmsnorm_ref(x, p["norm"], eps)[:, -1],
                    p["head"].to(dtype))[0]


def tick_breakdown(torch, server, prompts):
    """Where a steady decode tick's time goes: wall time per tick with 8
    running requests (host clock, synchronised), and the card's busy time
    per tick by kernel family from torch.profiler over the same ticks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(BATCH_SLOTS):
        server.submit(prompts[i][:128], max_new_tokens=24, seed=i)
    for _ in range(3):                 # admit all eight, settle
        server.step()
    n = 6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        server.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            server.step()
        torch.cuda.synchronize()
    server.run()
    fam = {"gemm": 0.0, "paged_decode": 0.0, "rmsnorm": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        name = ev.key.lower()
        key = next((k for part, k in (("decode_attention", "paged_decode"),
                                      ("rmsnorm", "rmsnorm"))
                    if part in name), None)
        if key is None:
            key = "gemm" if any(w in name for w in (
                "gemm", "nvjet", "cutlass", "xmma")) else "other"
        fam[key] += us / 1e3 / n
    busy = sum(fam.values())
    if busy > 0:
        parts = ", ".join(f"{k} {v:.3f}" for k, v in fam.items())
        print(f"[serve] decode tick, 8 running rows: wall {wall:.2f} ms "
              f"(host clock); card busy {busy:.2f} ms = "
              f"{100 * busy / wall:.1f}% of the wall (idle "
              f"{100 * (1 - busy / wall):.1f}%); busy ms by family: "
              f"{parts}", flush=True)
    else:
        print(f"[serve] decode tick, 8 running rows: wall {wall:.2f} ms "
              f"(host clock); card busy time not measured (torch.profiler "
              f"recorded no device time)", flush=True)


def load_net(torch):
    from mxnet_tpu_torch.models import get_model

    t0 = time.perf_counter()
    net = get_model("llama_3_8b", device="cuda")    # seed 0, std 0.02
    cfg = net.cfg
    n_params = sum(p.numel() for p in net.parameters())
    torch.cuda.synchronize()
    print(f"[serve] llama_3_8b vocab={cfg.vocab_size} D={cfg.hidden_size} "
          f"I={cfg.intermediate_size} layers={cfg.num_layers} (no depth "
          f"cut) heads={cfg.num_heads}/{cfg.num_kv_heads} {cfg.dtype}: "
          f"{n_params / 1e9:.2f} B random parameters in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rs = np.random.RandomState(SEED)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(33, MAX_PROMPT + 1)))
               for _ in range(N_REQUESTS)]
    return net, prompts


def expect_launches(counts, expect, label):
    """Every kernel's launch count over one run equals its expected count
    (0 for the kernels the run must not reach)."""
    expect = {sym: expect.get(sym, 0) for sym in counts}
    print(f"[{label}] launches {counts} expected {expect}", flush=True)
    for sym, n in expect.items():
        check(counts[sym] == n,
              f"{label}: {sym}: {counts[sym]} launches, expected {n}")


def served_run(torch, server, prompts, label):
    """The 16 requests through `server`, counted from zero: greedy rows
    plus every fourth row sampled. Returns (requests, launch counts,
    prefills, ticks)."""
    from mxnet_tpu_torch.kernels import _build
    cfg = server.cfg
    pool_gb = sum(t.numel() * t.element_size() for pg in server.cache.pages
                  for t in pg.values()) / 1e9
    # warm-up (cuBLAS handles, allocator) outside the counted run
    server.submit(prompts[0][:8], max_new_tokens=2)
    server.run()

    _build.reset_launch_counts()
    pf0 = server.programs["prefill"].calls
    dc0 = server.programs["decode"].calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = []
    for i, p in enumerate(prompts):
        hot = i % 4 == 3                  # every fourth row samples
        reqs.append(server.submit(
            p, max_new_tokens=NEW_TOKENS, temperature=0.8 if hot else 0.0,
            top_k=50 if hot else 0, top_p=0.9 if hot else 0.0, seed=i))
    server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    prefills = server.programs["prefill"].calls - pf0
    ticks = server.programs["decode"].calls - dc0

    n_tok = sum(len(r.output_tokens) for r in reqs)
    for r in reqs:
        check(r.status == "ok" and len(r.output_tokens) == NEW_TOKENS,
              f"request {r.id}: status {r.status}, "
              f"{len(r.output_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"request {r.id}: token out of range")
    ttft = sorted(r.ttft for r in reqs)
    print(f"[{label}] {N_REQUESTS} requests (prompts {min(map(len, prompts))}"
          f"-{max(map(len, prompts))} tokens, {NEW_TOKENS} new each, "
          f"{sum(1 for i in range(N_REQUESTS) if i % 4 == 3)} sampled), "
          f"kv_cache_dtype {server.kv_cache_dtype}, "
          f"pool {pool_gb:.2f} GB: {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tokens/s, {ticks} ticks, {prefills} "
          f"prefills, TTFT p50 {ttft[len(ttft) // 2]:.3f} s, "
          f"preemptions {server.preemptions}", flush=True)
    return reqs, counts, prefills, ticks


def serve(torch, F, net, prompts):
    from mxnet_tpu_torch.serving import InferenceServer

    cfg = net.cfg
    server = InferenceServer(net, batch_slots=BATCH_SLOTS,
                             block_size=BLOCK_SIZE, max_len=MAX_LEN,
                             max_prompt_len=MAX_PROMPT)
    reqs, counts, prefills, ticks = served_run(torch, server, prompts,
                                               "serve")
    expect_launches(counts, {
        "mxtt_rmsnorm": (2 * cfg.num_layers + 1) * (prefills + ticks),
        "mxtt_flash_prefill": cfg.num_layers * prefills,
        "mxtt_paged_decode": cfg.num_layers * ticks}, "serve")

    # request 0's prefill: kernel path (scratch block table, so the pool
    # is untouched) against the plain versions on the unpadded prompt
    p0 = prompts[0]
    ids = np.zeros((1, MAX_PROMPT), np.int64)
    ids[0, :len(p0)] = p0
    kern = server.programs["prefill"](
        server._params, server.cache.pages,
        torch.zeros(MAX_LEN // BLOCK_SIZE, dtype=torch.int32, device="cuda"),
        torch.from_numpy(ids).cuda(),
        torch.tensor([len(p0)], dtype=torch.int32, device="cuda"))[0]
    with torch.inference_mode():
        plain = plain_prefill_logits(torch, F, net, p0, torch.bfloat16)
        truth = plain_prefill_logits(torch, F, net, p0, torch.float32)
    err = max_err(kern, plain)
    err_kernel, err_plain = max_err(kern, truth), max_err(plain, truth)
    cos = float(F.cosine_similarity(kern.float(), plain.float(), dim=0))
    # both bf16 paths round 32 layers of activations at different points
    # (fused norm, fp32 P in attention, padded vs unpadded prompt): the
    # kernel path may stand no further from the fp32 result than twice
    # the plain bf16 path does
    tol = 2 * err_plain
    check(bool(torch.isfinite(kern).all()) and err_kernel <= tol,
          f"prefill logits: kernel path {err_kernel} from fp32 > tol {tol}")
    print(f"[serve] request 0 prefill logits ({len(p0)} tokens, max|logit| "
          f"{float(truth.abs().max()):.4g}): kernel vs plain bf16 "
          f"max_abs_err={err:.4g} cosine={cos:.6f}; from fp32: kernel "
          f"{err_kernel:.4g}, plain {err_plain:.4g}, tol {tol:.4g}; argmax "
          f"kernel/plain/fp32 {int(kern.float().argmax())}/"
          f"{int(plain.float().argmax())}/{int(truth.argmax())}", flush=True)
    tick_breakdown(torch, server, prompts)
    return counts, [r.output_tokens[0] for r in reqs]


def serve_int8(torch, net, prompts, first_bf16):
    """The same 16 requests through an int8-pool server of the same
    geometry: every request ok, the int8 paged kernel and never the bf16
    one, and each greedy request's first token equal to the bf16
    server's (it comes from the prefill logits, which read no pool)."""
    from mxnet_tpu_torch.serving import InferenceServer

    cfg = net.cfg
    server = InferenceServer(net, batch_slots=BATCH_SLOTS,
                             block_size=BLOCK_SIZE, max_len=MAX_LEN,
                             max_prompt_len=MAX_PROMPT, kv_cache_dtype="int8")
    reqs, counts, prefills, ticks = served_run(torch, server, prompts,
                                               "serve int8")
    expect_launches(counts, {
        "mxtt_rmsnorm": (2 * cfg.num_layers + 1) * (prefills + ticks),
        "mxtt_flash_prefill": cfg.num_layers * prefills,
        "mxtt_paged_decode_q8": cfg.num_layers * ticks}, "serve int8")
    greedy = [i for i in range(N_REQUESTS) if i % 4 != 3]
    same = [reqs[i].output_tokens[0] == first_bf16[i] for i in greedy]
    check(all(same), f"serve int8: first tokens differ from the bf16 "
                     f"server's in requests "
                     f"{[i for i, ok in zip(greedy, same) if not ok]}")
    print(f"[serve int8] first token of all {len(greedy)} greedy requests "
          f"equal to the bf16 server's", flush=True)
    return counts


# -- phase 4: generate ---------------------------------------------------------

def teacher_forced(net, kv, ids, valid_len, toks):
    """fp32 logits (B, V) of each step of `net`'s contiguous-cache decoder
    with `kv` cache, prefilled with `ids` and fed `toks` (B, steps)."""
    from mxnet_tpu_torch.models.llama_infer import _params_tree
    from mxnet_tpu_torch.serving.executables import decoder_programs

    dec = decoder_programs(net, ids.shape[1] + toks.shape[1], kv)
    params = _params_tree(net)
    cache, _ = dec["prefill"](params, ids, valid_len)
    out = []
    for j in range(toks.shape[1]):
        cache, logits = dec["step"](params, cache, valid_len.long() + j,
                                    toks[:, j])
        out.append(logits.float())
    return out


def max_rel_dev(ref, other):
    """The JAX package's drift statistic (test_llama_infer.py): the
    largest per-step max|a - b| / max|a| over a run of steps."""
    return max(float((a - b).abs().max() / a.abs().max())
               for a, b in zip(ref, other))


def generate_phase(torch, net, prompts):
    """Contiguous-cache generate() on the 8B net: 8 prompts right-padded
    to 512 with ragged valid_len, 32 greedy tokens with a bf16 and with an
    int8 cache; exact launch counts; the first tokens agree (prefill
    logits); 32 teacher-forced steps of both caches within max(2%, twice
    the bf16 path's deviation from fp32) relative logit difference (the
    JAX package's statistic, test_llama_infer.py); then generate_beam on
    two prompts. Returns the launch counts of the bf16,
    int8 and beam runs."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.models import generate, generate_beam
    from mxnet_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = net.cfg
    L, per_fwd = cfg.num_layers, 2 * cfg.num_layers + 1
    B, T, new = BATCH_SLOTS, MAX_PROMPT, NEW_TOKENS
    ids = np.zeros((B, T), np.int64)
    vl = np.asarray([len(p) for p in prompts[:B]], np.int32)
    for b, p in enumerate(prompts[:B]):
        ids[b, :len(p)] = p
    generate(net, ids[:, :8], 2)             # warm-up outside the counts
    runs, outs = {}, {}
    for kv, sym in (("model", "mxtt_contig_decode"),
                    ("int8", "mxtt_contig_decode_q8")):
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(net, ids, new, valid_len=vl, kv_cache_dtype=kv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[kv] = counts = _build.launch_counts()
        check(out.shape == (B, T + new) and (out[:, :T] == ids).all(),
              f"generate {kv}: output shape {out.shape} or prompt changed")
        check(((out >= 0) & (out < cfg.vocab_size)).all(),
              f"generate {kv}: token out of range")
        outs[kv] = out
        print(f"[generate] kv_cache_dtype {kv}: B={B} prompts right-padded "
              f"to {T} (valid_len {vl.min()}-{vl.max()}), {new} greedy "
              f"tokens each: {B * new} tokens in {wall:.2f} s = "
              f"{B * new / wall:.1f} tokens/s", flush=True)
        expect_launches(counts, {"mxtt_rmsnorm": per_fwd * (1 + new),
                                 "mxtt_flash_prefill": L,
                                 sym: L * new}, f"generate {kv}")
    first = outs["model"][:, T] == outs["int8"][:, T]
    check(first.all(), f"generate: first tokens differ between the bf16 "
                       f"and int8 caches in rows {np.where(~first)[0]}")
    agree = float((outs["model"][:, T:] == outs["int8"][:, T:]).mean())
    print(f"[generate] first token equal in all {B} rows between the bf16 "
          f"and int8 caches; {100 * agree:.1f}% of all generated tokens "
          f"equal (free-running: one near-tie flips the rest of a row)",
          flush=True)

    # teacher forcing: the bf16 cache, the int8 cache, and an fp32 copy
    # of the net with an fp32 cache (exact arithmetic, to measure the
    # bf16 path's own error), all fed the bf16 run's tokens
    net32 = LlamaForCausalLM(LlamaConfig(dtype="float32"), device="cuda")
    with torch.no_grad():
        for p, p32 in zip(net.parameters(), net32.parameters()):
            p32.copy_(p)
    toks = torch.from_numpy(outs["model"][:, T:]).cuda().long()
    ids_t, vl_t = torch.from_numpy(ids).cuda(), torch.from_numpy(vl).cuda()
    lg = {name: teacher_forced(n, kv, ids_t, vl_t, toks)
          for name, (n, kv) in (("bf16", (net, "model")),
                                ("int8", (net, "int8")),
                                ("fp32", (net32, "model")))}
    del net32
    torch.cuda.empty_cache()
    dev_q8 = max_rel_dev(lg["bf16"], lg["int8"])
    floor = max_rel_dev(lg["fp32"], lg["bf16"])
    # the JAX package bounds dev_q8 by 2% on its 2-layer fp32 llama_tiny,
    # where arithmetic adds nothing; at full width the random 32-layer net
    # amplifies any perturbation, and bf16 arithmetic alone moves its
    # logits by `floor` from exact. An int8 cache whose folds or scales
    # were wrong moves them by O(1); a right one by the order of `floor`.
    tol = max(0.02, 2 * floor)
    check(dev_q8 <= tol, f"generate: int8 teacher-forced logits differ by "
                         f"{dev_q8:.4f} relative (> {tol:.4f})")
    print(f"[generate] teacher-forced {new} steps, max relative logit "
          f"difference (max|a-b| / max|a| per step): int8 vs bf16 cache "
          f"{dev_q8:.5f}, tol {tol:.5f} = max(0.02, 2 x bf16 vs fp32 "
          f"{floor:.5f}); int8 (bf16 net) vs fp32 "
          f"{max_rel_dev(lg['fp32'], lg['int8']):.5f}", flush=True)

    # beam search on two prompts of one length
    W, new_b = 4, 8
    Tb = min(len(prompts[0]), len(prompts[1]))
    beam_ids = np.stack([prompts[0][:Tb], prompts[1][:Tb]])
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate_beam(net, beam_ids, new_b, beam_size=W)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs["beam"] = counts = _build.launch_counts()
    check(out.shape == (2, Tb + new_b)
          and ((out >= 0) & (out < cfg.vocab_size)).all(),
          f"generate_beam: shape {out.shape} or token out of range")
    print(f"[generate] generate_beam 2 prompts of {Tb} tokens, beam_size "
          f"{W}, {new_b} new: {2 * new_b} tokens in {wall:.2f} s = "
          f"{2 * new_b / wall:.1f} tokens/s", flush=True)
    expect_launches(counts, {"mxtt_rmsnorm": per_fwd * new_b,
                             "mxtt_flash_prefill": L,
                             "mxtt_contig_decode": L * (new_b - 1)},
                    "generate_beam")
    return runs


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import mxnet_tpu_torch  # noqa: F401
        from mxnet_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = card_line()
        print(f"[device] {card}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        _build.load_library()
        print(f"[device] kernels built from mxnet_tpu_torch/csrc into "
              f"{_build.library_path().parent} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        main_len = int(np.random.RandomState(SEED).randint(33, MAX_PROMPT + 1))
        # the plain prefill's bf16 P @ V must accumulate in fp32, as its
        # tolerance assumes: no bf16 split-K reductions while it is held
        # against the kernel
        matmul = torch.backends.cuda.matmul
        reduced = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            entries = [kernel_rmsnorm(torch, F, flush),
                       kernel_flash_prefill(torch, F, flush, main_len),
                       kernel_paged_decode(torch, F, flush)]
            entries += [kernel_decode(torch, F, flush, name)
                        for name in DECODE_KERNELS]
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        del flush
        torch.cuda.empty_cache()
        net, prompts = load_net(torch)
        counts, first_bf16 = serve(torch, F, net, prompts)
        torch.cuda.empty_cache()
        counts_q8 = serve_int8(torch, net, prompts, first_bf16)
        torch.cuda.empty_cache()
        gen_counts = generate_phase(torch, net, prompts)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    decode_src = "mxnet_tpu_torch/csrc/decode_attention.cu"
    # (symbol, source, TPU kernel's pallas_call, the main-path run whose
    # launch count the line reports)
    meta = {"rmsnorm": ("mxtt_rmsnorm", "mxnet_tpu_torch/csrc/rmsnorm.cu",
                        "mxnet_tpu/kernels/fused_norm.py:91", counts),
            "flash_prefill": ("mxtt_flash_prefill",
                              "mxnet_tpu_torch/csrc/flash_prefill.cu",
                              "mxnet_tpu/kernels/flash_attention.py:188",
                              counts),
            "paged_decode": ("mxtt_paged_decode", decode_src,
                             "mxnet_tpu/kernels/flash_decode.py:307",
                             counts),
            "contig_decode": ("mxtt_contig_decode", decode_src,
                              "mxnet_tpu/kernels/flash_decode.py:147",
                              gen_counts["model"]),
            "contig_decode_q8": ("mxtt_contig_decode_q8", decode_src,
                                 "mxnet_tpu/kernels/flash_decode.py:762",
                                 gen_counts["int8"]),
            "paged_decode_q8": ("mxtt_paged_decode_q8", decode_src,
                                "mxnet_tpu/kernels/flash_decode.py:376",
                                counts_q8)}
    # the TPU kernel and the error are read under two names each
    # (replaces/tpu_kernel, max_abs_err/max_err): one value, both keys
    kernels = []
    for e in entries:
        sym, src, tpu, run = meta[e["name"]]
        kernels.append({"name": e["name"], "route": "cuda", "source": src,
                        "replaces": tpu, "tpu_kernel": tpu,
                        "launches": run[sym],
                        "max_abs_err": e["max_abs_err"],
                        "max_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"],
                        "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
                        "library_ms": e["library_ms"], "shape": e["shape"]})
    print(card)                       # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

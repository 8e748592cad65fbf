#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`mxnet_tpu_torch`).

    python3 chip_smoke.py          # one CUDA card, nvcc on PATH or CUDA_HOME

Phases, each printing its lines before the next starts; any failure
exits non-zero and prints no result:

1. device: the card's name and power limit (nvidia-smi), then the build
   of every kernel from `mxnet_tpu_torch/csrc` (nvcc, sm_90a), and the
   tensor-core attention kernels' registers and spills (`ptxas -v`),
   setmaxnreg split and dynamic shared memory.
2. kernels: each CUDA kernel against its plain PyTorch version at the
   serving and generation paths' own shapes (bf16) plus ragged cases,
   every element within its own stated tolerance; at the main shapes,
   attention made off by one at the key length or the diagonal must fall
   outside it; kernel, plain and library (yardstick only: the port never
   calls it) times with a cold L2, and the least time the card could
   take for the same work. The int8 decode kernels read caches quantized
   from rows whose magnitudes vary by token. Then the training step's
   kernels at the train phase's shapes: RMSNorm with its rrms and the dx
   kernel (4096 x 4096 bf16), the attention forward with its lse and the
   dq and dkv kernels (B=2, T=2048, H=32, K=8, d=128, causal) in bf16
   (the tensor-core forward, dq and dkv) and in fp32 (the SIMT kernels)
   plus a ragged and a tiny fp32 case with an empty row, a backward off
   by one at the diagonal falling outside the tolerances, dq and dkv
   equal bit for bit over two launches, the SIMT kernels timed on the
   bf16 inputs beside the tensor-core ones, and the fused CE
   forward and backward (N=4096, V=32000) with a label off by one
   falling outside them. Then BERT's kernels: the LayerNorm forward
   (with and without mu and rstd) and dx at BERT-base's rows (4096 x
   768 bf16), BERT-large's (4096 x 1024), transformer_base's (4096 x 512
   fp32), ragged, unaligned and block-per-row cases, rows offset so that
   the centred variance matters, the neighbouring row's statistics and
   dx without its xhat term falling outside the tolerances; and the
   attention forward with lse, dq and dkv at BERT-base's self-attention
   (B=32, T=128, H=K=12, d=64, full, key padding from lengths in
   [64, 128]) and a small fp32 case, lengths off by one falling outside
   the tolerances, timed beside SDPA with a key-padding mask.
3. serve: Llama-3-8B at full width (vocab 32000, D 4096, I 14336, 32
   layers, 32 heads / 8 kv heads, bf16; random weights from a seed)
   behind `InferenceServer(batch_slots=8, block_size=16, max_len=2048,
   max_prompt_len=512)`: 16 requests of 33-512 prompt tokens, 32 new
   tokens each, greedy plus top-k/top-p rows. Every kernel's launch
   count over that run must equal its expected count (RMSNorm 65 per
   forward, the tensor-core attention forward 32 per request, decode 32
   per tick, 0 for the others); request 0's prefill is re-run with the
   plain versions and the last-position logits compared. Then a steady
   decode tick's wall time and the card's busy time in it, by kernel
   family (torch.profiler). Then the same 16 requests through a server with
   an int8 pool (`kv_cache_dtype="int8"`): the int8 paged kernel 32
   times per tick, the bf16 one never, each greedy request's first token
   equal to the bf16 server's. Then the prefix cache, chunked prefill
   and speculation (`prefix_cache=True, prefill_chunk_tokens=256,
   speculative=4`): a 392-token prefix, six extensions forking its tail
   block by copy-on-write, a repeat that skips its prefill, and eight
   others; exact launch counts (window kernel 32 per chunk and per verify
   tick); the last logits of an extension's chunk, of a 512-token
   prompt's second chunk and of the repeat's warm tick against the plain
   versions. Then an oracle proposer drafting the plain server's tokens:
   drafts accepted, the tokens the plain server's where its margin
   allows.
4. generate: `generate()` on the same net, 8 prompts right-padded to
   512 (valid_len 33-512), 32 greedy tokens, with a bf16 and with an
   int8 cache: exact launch counts (contiguous decode 32 per step), the
   same first token in every row, and 32 teacher-forced steps of both
   caches within max(2%, twice the bf16 path's own deviation from an
   fp32 copy of the net) relative logit difference; then `generate_beam` on
   two prompts (beam_size 4, 8 new tokens). Tokens/s of each run.
5. train: with the serving net freed, Llama-3-8B at full width cut to 4
   layers (1.13 B parameters) behind `FusedTrainStep` with AdamW (lr
   3e-4, wd 0.1) and `SoftmaxCrossEntropyLoss`, one batch of B=2 x
   T=2048 tokens: one step's gradients through the kernels held per
   parameter against the plain versions' (torch autograd) and an fp32
   copy's, and the fp32 copy once through the kernels (the SIMT
   attention route, exact launch counts, gradients within 2^-12 of its
   plain path's); five steps with exact launch counts (per step RMSNorm
   and its dx 2L + 1 each, the tensor-core attention forward, dq and dkv
   L each, CE forward and backward 1 each), finite and
   strictly falling losses; train tokens/s
   over steps 2-5; one more step's card time by kernel family.
6. bert: BERT-base (vocab 30522, 768 units, 12 layers, 12 heads, bf16
   by `amp.convert_block`, random weights from the seed) behind
   `FusedTrainStep(n_model_inputs=3)` with AdamW (lr 1e-4, wd 0.01,
   multi_precision=True) and bench.py's masked-MLM plus NSP loss, one
   batch of B=32 x T=128 (valid_length 64-128, 15% MLM mask), dropout
   0.1 from a seeded generator: one step's gradients through the kernels
   held per parameter against the plain versions' and an fp32 copy's
   (the generator reseeded for each, so all draw the same masks); five
   steps with exact launch counts per step (LayerNorm and its dx 26
   each, attention forward, dq and dkv 12 each, CE 1 and 1), finite
   losses, the fifth below the first; samples/s over steps 2-5; one more
   step's card time by kernel family.
7. transformer: transformer_base (bf16 weights) on B=32, src and tgt
   T=128 with src_valid_len from the seed: the gradient check as in
   phase 6, then one step with exact launch counts (LayerNorm and its dx
   32 each, CE 1 and 1, attention kernels 0: every attention of the
   Transformer carries a mask) and a finite loss.
8. the kernels line (JSON), the card line, and the result line
   `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import contextlib
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


def attn_fwd_tol(torch, q, k, v, ref, scale, lengths, causal):
    """Element-wise tolerance of an attention forward's output against
    its plain version `ref` (reference_attention) on the same inputs. In
    fp32 both differ by fp32 noise of the row's sum of p * |v|. In bf16:
    - the plain version rounds the normalised P to bf16 before P @ V, as
      the JAX reference does: one rounding of each p, 2^-8 of the row's
      sum of p * |v| (BF16_ROUND);
    - the tensor-core kernel (the bf16 route, csrc/flash_fwd_sm90.cu)
      rounds its own P to bf16 for the wgmma, unnormalised against the
      running max, at another point than the plain version does: another
      2^-8 of the same sum (the second BF16_ROUND);
    - each rounds its output once: one bf16 step of |ref| (BF16_STEP)."""
    _, pv_abs = attn_apply(torch, attn_probs(torch, q, k, scale, lengths,
                                             causal), v, q.shape[2])
    if ref.dtype != torch.bfloat16:
        return FP32_NOISE * pv_abs
    return BF16_STEP * ref.float().abs() \
        + (2 * BF16_ROUND + FP32_NOISE) * pv_abs


def attn_bwd_tols(torch, terms, refs):
    """Element-wise tolerances of (dq, dk, dv) against their plain
    versions `refs` (flash_bwd_dq_ref, flash_bwd_dkv_ref), from `terms`,
    each output's sums of |terms| (attn_backward_fp32). Both compute in
    fp32 from the same inputs, lse and delta (fp32 noise of the terms).
    In bf16 each rounds once (one bf16 step of |ref|), and the
    tensor-core kernels round to bf16 before their last products: dq
    (csrc/flash_bwd_dq_sm90.cu) dS before dS K, dkv
    (csrc/flash_bwd_dkv_sm90.cu) P and dS before P^T dO and dS^T Q. Each
    term of dq, dk and dv moves by at most 2^-8 of itself (BF16_ROUND of
    the terms)."""
    bf16 = refs[0].dtype == torch.bfloat16
    tols = []
    for t, r in zip(terms, refs):
        tol = FP32_NOISE * t
        if bf16:
            tol = tol + BF16_STEP * r.float().abs() + BF16_ROUND * t
        tols.append(tol)
    return tols


def cached_attention(torch, q, k_cache, v_cache, valid_lens, scale):
    """fp32 attention of window rows q (B, W, H, d) over a gathered
    (B, K, S, d) cache, row w's keys masked at valid_lens[b, w] and an
    empty row 0: (p @ v, p @ |v|), each (B, W, H, d), the second the
    scale of the row's rounding terms. A decode step is the window W = 1:
    q[:, None] and valid_len[:, None]."""
    B, W, H, d = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    s = torch.einsum("bwkrd,bksd->bwkrs",
                     q.reshape(B, W, K, H // K, d).float(),
                     k_cache.float()) * scale
    keep = (torch.arange(S, device=q.device)[None, None, :]
            < valid_lens[:, :, None].long())[:, :, None, None, :]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    p = torch.where(keep.any(dim=-1, keepdim=True), p, 0.0)
    vf = v_cache.float()
    return tuple(torch.einsum("bwkrs,bksd->bwkrd", p, t).reshape(B, W, H, -1)
                 for t in (vf, vf.abs()))


def tc_resources():
    """One line per tensor-core attention kernel: its registers and spills
    as `ptxas -v` reported them when this checkout built it, and the
    dynamic shared memory and setmaxnreg split of its launch."""
    import ctypes
    import re

    from mxnet_tpu_torch.kernels import _build
    lib = _build.load_library()
    lines = []
    for stem, sym in (("flash_fwd_sm90", "mxtt_flash_fwd_tc_info"),
                      ("flash_bwd_dq_sm90", "mxtt_flash_bwd_dq_tc_info"),
                      ("flash_bwd_dkv_sm90", "mxtt_flash_bwd_dkv_tc_info")):
        report = _build.ptxas_report(stem)
        found = {}
        for part in report.split("Compiling entry function")[1:]:
            d = re.search(r"ILi(\d+)E", part)
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", part)
            if d and regs and spill:
                found[int(d.group(1))] = (regs.group(1), *spill.groups())
        warns = [w.strip() for w in report.splitlines() if "warning" in w]
        query = getattr(lib, sym)
        query.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        query.restype = ctypes.c_int
        for d in (64, 128):
            info = (ctypes.c_int * 3)()
            check(query(d, info) == 0, f"{sym}({d}) failed")
            if d in found:
                regs, stack, st, ld = found[d]
                text = f"ptxas: {regs} registers a thread at entry, " \
                       f"{stack} bytes stack, {st} bytes spill stores, " \
                       f"{ld} bytes spill loads"
            else:
                text = "ptxas: no report (the library was not built by " \
                       "this checkout)"
            lines.append(f"[device] {stem} d={d}: {text}; setmaxnreg: "
                         f"producer {info[1]}, consumers {info[2]} "
                         f"registers a thread; dynamic shared memory "
                         f"{info[0]} bytes"
                         + (f"; warnings: {warns}" if warns else ""))
    return lines


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
        tol = attn_fwd_tol(torch, q, k, v, ref, scale, lengths, True)
        err, text = held(torch, f"flash_fwd {label}", out, ref, tol)
        line = f"[kernels] flash_fwd {label} B={B} T={T} H={H} K={K} " \
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
                caught(torch, f"flash_fwd {name}",
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
            simt = cold_ms(torch, lambda: simt_forward(
                torch, q, k, v, True, scale, lengths, with_lse=False),
                flush, reps=10)
            line += f" ms={ms:.4f} plain_ms={plain:.4f} library_ms=" \
                    f"{lib:.4f} bound_ms={b_ms:.4f} ({b_by}); SIMT version " \
                    f"on the same inputs ms={simt:.4f}"
            entry = dict(name="flash_fwd_tc", max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, simt_ms=simt,
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
        _, pv_abs = cached_attention(torch, q[:, None], kc, vc,
                                     vl_t[:, None], scale)
        tol = FP32_NOISE * pv_abs[:, 0]
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
                       cached_attention(torch, q[:, None], kc, vc,
                                        (vl_t + dv)[:, None], scale)[0][:, 0]
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
        _, pv_abs = cached_attention(torch, q[:, None], kd, vd,
                                     vl_t[:, None], scale)
        tol = FP32_NOISE * pv_abs[:, 0]
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
                       cached_attention(torch, q[:, None], kd, vd,
                                        (vl_t + dv)[:, None], scale)[0][:, 0]
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


def kernel_paged_window(torch, F, flush):
    """The window kernel against its plain version at the two shapes the
    spec serve phase gives it: a 256-token prefill chunk (B=1, W=256) at
    positions 256-511 over the earlier tokens, and a verify tick (B=8,
    W=5: token 0 + 4 drafts) over 130-500 cached tokens per row; plus
    ragged windows (rows past a short draft at valid length 1, a row
    whose window starts at position 0) and d=16 in fp32."""
    from mxnet_tpu_torch.kernels.flash_decode import (
        flash_decode_paged_window, gather_kv_pages,
        reference_paged_window_attention)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rs = np.random.RandomState(SEED + 6)
    chunk = np.arange(257, 513)[None]
    verify = rs.randint(130, 501, BATCH_SLOTS)[:, None] + np.arange(1, 6)
    ragged = np.asarray([[1, 2, 3, 4, 5, 6, 7],
                         [300, 301, 1, 1, 1, 1, 1],
                         [17, 18, 19, 20, 21, 22, 23]])
    cases = (("chunk", 32, 8, 128, BLOCK_SIZE, MAX_LEN, chunk,
              torch.bfloat16),
             ("verify", 32, 8, 128, BLOCK_SIZE, MAX_LEN, verify,
              torch.bfloat16),
             ("ragged", 32, 8, 128, BLOCK_SIZE, 512, ragged, torch.bfloat16),
             ("tiny fp32", 4, 2, 16, 8, 64, np.asarray([[1, 2, 3],
                                                        [62, 63, 64]]),
              torch.float32))
    entry, timed = None, {}
    for label, H, K, d, bs, max_len, vls, dtype in cases:
        B, W = vls.shape
        nb = max_len // bs
        N = B * nb + 1
        q = torch.randn(B, W, H, d, generator=gen, device="cuda").to(dtype)
        kp = torch.randn(N, K, bs, d, generator=gen, device="cuda").to(dtype)
        vp = torch.randn(N, K, bs, d, generator=gen, device="cuda").to(dtype)
        # shuffled physical blocks; entries past each row's longest window
        # stay at the scratch block 0
        bt = np.zeros((B, nb), np.int32)
        ids = 1 + rs.permutation(N - 1)
        for b in range(B):
            nblk = -(-int(vls[b].max()) // bs)
            bt[b, :nblk] = ids[b * nb:b * nb + nblk]
        bt_t = torch.from_numpy(bt).cuda()
        vl_t = torch.from_numpy(vls.astype(np.int32)).cuda()
        scale = 1.0 / math.sqrt(d)
        out = flash_decode_paged_window(q, kp, vp, bt_t, vl_t, scale)
        ref = reference_paged_window_attention(q, kp, vp, bt_t, vl_t, scale)
        torch.cuda.synchronize()
        # the plain version works in fp32 throughout: both round the
        # output once (one bf16 step of |ref|) or differ by fp32 noise
        kc, vc = gather_kv_pages(kp, bt_t), gather_kv_pages(vp, bt_t)
        _, pv_abs = cached_attention(torch, q, kc, vc, vl_t, scale)
        tol = FP32_NOISE * pv_abs
        if dtype == torch.bfloat16:
            tol = tol + BF16_STEP * ref.float().abs()
        err, text = held(torch, f"paged_window {label}", out, ref, tol)
        line = f"[kernels] paged_window {label} B={B} W={W} H={H} K={K} " \
               f"d={d} bs={bs} valid_lens {int(vls.min())}-" \
               f"{int(vls.max())} {dtype}: {text}"
        if label == "chunk":
            # every row seeing one key too many (row w attending w + 1
            # keys of the window) or one too few must fail the tolerance
            line += "; off by one: " + ", ".join(
                caught(torch, f"paged_window {name}",
                       cached_attention(torch, q, kc, vc, vl_t + dv,
                                        scale)[0].to(dtype), ref, tol)
                for name, dv in (("valid_lens+1", 1), ("valid_lens-1", -1)))
        if label in ("chunk", "verify"):
            ms = cold_ms(torch, lambda: flash_decode_paged_window(
                q, kp, vp, bt_t, vl_t, scale), flush)
            plain = cold_ms(torch, lambda: reference_paged_window_attention(
                q, kp, vp, bt_t, vl_t, scale), flush)
            S = kc.shape[2]
            mask = (torch.arange(S, device="cuda")[None, None, :]
                    < vl_t[:, :, None])[:, None]           # (B, 1, W, S)
            qt = q.transpose(1, 2)
            lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask, enable_gqa=True), flush)
            # this run's work: each window row attends its own valid
            # length; each batch row's keys below its longest window are
            # read once per kv head, q read and out written once
            keys = int(vls.max(axis=1).sum())
            nbytes = (2 * q.numel() + 2 * keys * K * d) * q.element_size() \
                + bt.nbytes + 4 * vls.size
            b_ms, b_by = bound(nbytes, int(vls.sum()) * H * 4 * d, "bf16")
            line += f" ms={ms:.4f} plain_ms={plain:.4f} library_ms=" \
                    f"{lib:.4f} (SDPA over the gathered cache, (W, S) mask; " \
                    f"gather not timed) bound_ms={b_ms:.4f} ({b_by})"
            timed[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by)
            if label == "chunk":
                entry = dict(name="paged_window", max_abs_err=err,
                             shape=f"B=1 W=256 H=32 K=8 d=128 bs=16 "
                                   f"valid_lens 257-512 bf16",
                             **timed["chunk"])
        print(line, flush=True)
    entry["verify"] = dict(timed["verify"],
                           shape=f"B=8 W=5 H=32 K=8 d=128 bs=16 valid_lens "
                                 f"{int(verify.min())}-{int(verify.max())} "
                                 f"bf16")
    return entry


# -- phase 2b: the training step's kernels at the train phase's shapes -------

#: the train phase (phase 5): Llama-3-8B widths cut to 4 layers, B=2, T=2048
TRAIN_LAYERS, TRAIN_B, TRAIN_T = 4, 2, 2048
TRAIN_ROWS = TRAIN_B * TRAIN_T        # rows of every norm and of the CE


def kernel_rmsnorm_train(torch, F, flush):
    """RMSNorm forward with its rrms and the dx kernel against their plain
    versions at the train shape (4096 x 4096 bf16) and a narrow fp32
    case. Returns (the forward's train-shape times, the dx entry)."""
    from mxnet_tpu_torch.kernels.fused_norm import (
        rmsnorm_dx, rmsnorm_dx_ref, rmsnorm_fwd, rmsnorm_fwd_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    eps = 1e-5
    fwd, entry = None, None
    for label, (n, d), dtype in (("train", (TRAIN_ROWS, 4096), torch.bfloat16),
                                 ("narrow fp32", (37, 64), torch.float32)):
        x = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
        g = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        dy = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
        out, rrms = rmsnorm_fwd(x, g, eps)
        ref, rrms_ref = rmsnorm_fwd_ref(x, g, eps)
        dx = rmsnorm_dx(x, g, rrms, dy)
        dx_ref = rmsnorm_dx_ref(x, g, rrms, dy)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        rtol = BF16_STEP if bf16 else 2.0 ** -19
        _, text = held(torch, f"rmsnorm {label}", out, ref,
                       rtol * ref.float().abs())
        # both sum d positive squares in fp32, each in a tree of depth
        # under 32 (about 2^-19 relative) and rsqrt halves it: 2^-16
        # leaves 8x headroom and stays under the 2^-12 that a wrong
        # divisor (d - 1) would make
        _, rtext = held(torch, f"rmsnorm rrms {label}", rrms, rrms_ref,
                        2.0 ** -16 * rrms_ref.abs())
        # dx: both compute r * (g dy - x corr) in fp32 with corr a d-term
        # mean in another sum order (fp32 noise of the terms' scale) and
        # round once (one bf16 step of |ref|)
        xs, r = x.float(), rrms[:, None]
        wdy = dy.float() * g
        corr = (wdy * xs).mean(dim=-1, keepdim=True) * r * r
        tol = FP32_NOISE * r * (wdy.abs() + (xs * corr).abs())
        if bf16:
            tol = tol + BF16_STEP * dx_ref.float().abs()
        err, dtext = held(torch, f"rmsnorm_dx {label}", dx, dx_ref, tol)
        line = f"[kernels] rmsnorm {label} {tuple(x.shape)} {dtype}: out " \
               f"{text}; rrms {rtext}; dx {dtext}"
        if label == "train":
            ms = cold_ms(torch, lambda: rmsnorm_fwd(x, g, eps), flush)
            plain = cold_ms(torch, lambda: rmsnorm_fwd_ref(x, g, eps), flush)
            gx = g.to(dtype)
            lib = cold_ms(torch, lambda: F.rms_norm(x, (d,), gx, eps), flush)
            b_ms, b_by = bound(2 * x.numel() * x.element_size() + d * 4
                               + n * 4, 4 * x.numel(), "fp32")
            fwd = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by, shape=f"x {tuple(x.shape)} bf16, "
                                            f"writing rrms")
            dms = cold_ms(torch, lambda: rmsnorm_dx(x, g, rrms, dy), flush)
            dplain = cold_ms(torch, lambda: rmsnorm_dx_ref(x, g, rrms, dy),
                             flush)
            # yardstick: the backward of F.rms_norm for x alone, its
            # forward graph built once and kept
            xr = x.detach().requires_grad_()
            y = F.rms_norm(xr, (d,), gx, eps)
            dlib = cold_ms(torch, lambda: torch.autograd.grad(
                y, xr, dy, retain_graph=True), flush)
            db_ms, db_by = bound(3 * x.numel() * x.element_size() + d * 4
                                 + n * 4, 6 * x.numel(), "fp32")
            line += f"; forward ms={ms:.4f} plain_ms={plain:.4f} " \
                    f"library_ms={lib:.4f} bound_ms={b_ms:.4f} ({b_by}); " \
                    f"dx ms={dms:.4f} plain_ms={dplain:.4f} library_ms=" \
                    f"{dlib:.4f} (F.rms_norm backward) bound_ms=" \
                    f"{db_ms:.4f} ({db_by})"
            entry = dict(name="rmsnorm_dx", max_abs_err=err, ms=dms,
                         plain_ms=dplain, library_ms=dlib, bound_ms=db_ms,
                         bound_by=db_by,
                         shape=f"x, dy {tuple(x.shape)} bf16")
        print(line, flush=True)
    return fwd, entry


def attn_backward_fp32(torch, q, k, v, dout, lse, delta, scale, lengths,
                       diag=0, causal=True, terms=True):
    """fp32 (dq, dk, dv) of attention from the forward's lse and delta,
    keys kept where s < lengths[b] and, if causal, s <= t + diag (a
    kernel off by one at the diagonal for diag = +-1), GQA groups
    summed; and, with `terms` and diag = 0, the scale of each output's
    terms (sums of |terms|), the scale of its fp32 rounding."""
    B, T, H, d = q.shape
    K = k.shape[2]
    rep = H // K
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf, dof = q.float(), dout.float()
    j = torch.arange(T, device=q.device)
    keep = (j[None, :] < lengths[:, None].long())[:, None, None, :]
    if causal:
        keep = keep & (j[None, :] <= j[:, None] + diag)[None, None]
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    del s, keep
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])

    def group(g):                           # (B, T, H, d) -> (B, T, K, d)
        return g.reshape(B, T, K, rep, d).sum(dim=3)
    grads = (torch.einsum("bhts,bshd->bthd", ds, kf) * scale,
             group(torch.einsum("bhts,bthd->bshd", ds, qf)) * scale,
             group(torch.einsum("bhts,bthd->bshd", p, dof)))
    if diag or not terms:
        return grads, None
    del ds
    mag = p * (torch.einsum("bthd,bshd->bhts", dof.abs(), vf.abs())
               + delta.abs()[..., None])
    del dp
    terms = (torch.einsum("bhts,bshd->bthd", mag, kf.abs()) * scale,
             group(torch.einsum("bhts,bthd->bshd", mag, qf.abs())) * scale,
             group(torch.einsum("bhts,bthd->bshd", p, dof.abs())))
    return grads, terms


def simt_forward(torch, q, k, v, causal, scale, lengths, with_lse=True):
    """The fp32 SIMT forward kernel (csrc/flash_prefill.cu) launched
    directly on operands that the port routes to the tensor-core kernel,
    for its time beside the new kernel's ("simt_ms")."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    B, T, H, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, device=q.device) if with_lse else None
    _build.launch(fa._FWD, q.device, out.data_ptr(), _build.ptr(lse),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                  B, T, H, k.shape[2], d, int(causal), float(scale),
                  _build.dtype_code(q))
    return out


def simt_dq(torch, q, k, v, dout, lse, delta, causal, scale, lengths):
    """The fp32 SIMT dq kernel (csrc/flash_backward.cu) launched directly,
    as simt_forward."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    dq = torch.empty_like(q)
    _build.launch(fa._DQ, q.device, dq.data_ptr(),
                  *fa._backward_args(q, k, v, dout, lse, delta, lengths),
                  int(causal), float(scale), _build.dtype_code(q))
    return dq


def simt_dkv(torch, q, k, v, dout, lse, delta, causal, scale, lengths):
    """The fp32 SIMT dkv kernel (csrc/flash_backward.cu) launched directly,
    as simt_forward."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_attention as fa
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(fa._DKV, q.device, dk.data_ptr(), dv.data_ptr(),
                  *fa._backward_args(q, k, v, dout, lse, delta, lengths),
                  int(causal), float(scale), _build.dtype_code(q))
    return dk, dv


def kernel_flash_train(torch, F, flush):
    """The attention forward with its lse and the dq and dkv kernels
    against their plain versions at the train shape (B=2, T=2048, H=32,
    K=8, d=128, causal) in bf16 (the tensor-core route) and in fp32 (the
    SIMT route, which an fp32 net takes), a ragged bf16 case and a tiny
    fp32 case with an empty row; dq and dkv run twice on the same inputs
    must be equal bit for bit. Returns (the tensor-core forward's
    train-shape times, the tensor-core dq and dkv entries, the SIMT
    forward, dq and dkv entries)."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = (("train", TRAIN_B, TRAIN_T, 32, 8, 128, [TRAIN_T] * TRAIN_B,
              torch.bfloat16),
             ("train fp32", TRAIN_B, TRAIN_T, 32, 8, 128, [TRAIN_T] * TRAIN_B,
              torch.float32),
             ("ragged", 2, 333, 32, 8, 128, [333, 150], torch.bfloat16),
             ("tiny fp32", 3, 77, 4, 2, 16, [77, 40, 0], torch.float32))
    out_entries = {}
    for label, B, T, H, K, d, lens, dtype in cases:
        q, dout = (torch.randn(B, T, H, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, T, K, d, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_forward(q, k, v, True, scale, lengths,
                                              return_lse=True)
        ref, lse_ref = fa.reference_attention_lse(q, k, v, True, scale,
                                                  lengths)
        delta = fa.attention_delta(out, dout)
        dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, True, scale, lengths)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, True, scale,
                                  lengths)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, dout, lse, delta, True, scale,
                                     lengths)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, dout, lse, delta,
                                              True, scale, lengths)
        torch.cuda.synchronize()
        tol = attn_fwd_tol(torch, q, k, v, ref, scale, lengths, True)
        _, otext = held(torch, f"flash_fwd {label}", out, ref, tol)
        # lse: scores are d-term fp32 dots and the row sum another order:
        # fp32 noise of the row's scale; +inf exactly on a row with no key
        empty = torch.isinf(lse_ref)
        check(bool((torch.isinf(lse) == empty).all())
              and bool((lse[empty] > 0).all()),
              f"flash_fwd {label}: lse is not +inf exactly on empty rows")
        fin = ~empty
        _, ltext = held(torch, f"flash_fwd lse {label}", lse[fin],
                        lse_ref[fin], FP32_NOISE * (1 + lse_ref[fin].abs()))
        (_, terms) = attn_backward_fp32(torch, q, k, v, dout, lse, delta,
                                        scale, lengths)
        tols = attn_bwd_tols(torch, terms, (dq_ref, dk_ref, dv_ref))
        del terms
        errs, texts = zip(*(held(torch, f"flash_{n} {label}", o, r, t)
                            for n, o, r, t in zip(
                                ("dq", "dk", "dv"), (dq, dk, dv),
                                (dq_ref, dk_ref, dv_ref), tols)))
        line = f"[kernels] flash backward {label} B={B} T={T} H={H} K={K} " \
               f"d={d} lengths={lens} {dtype}: out {otext}; lse {ltext}; " \
               + "; ".join(f"{n} {t}" for n, t in zip(("dq", "dk", "dv"),
                                                      texts))
        if label == "train":
            # a backward off by one at the diagonal (each row seeing one
            # key more or one fewer) would fail the same tolerances
            wrong = []
            for dg in (-1, 1):
                grads, _ = attn_backward_fp32(torch, q, k, v, dout, lse,
                                              delta, scale, lengths, dg)
                wrong += [caught(torch, f"flash_{n} diagonal{dg:+d}",
                                 w.to(dtype), r, t)
                          for n, w, r, t in zip(("dq", "dk", "dv"), grads,
                                                (dq_ref, dk_ref, dv_ref),
                                                tols)]
                del grads
            line += "; off by one: " + ", ".join(wrong)
            # no atomics: each dQ, dK, dV row has one writer and sums its
            # keys (dq) or query heads (dkv) in one order
            dq2 = fa.flash_bwd_dq(q, k, v, dout, lse, delta, True, scale,
                                  lengths)
            check(torch.equal(dq, dq2),
                  "flash_bwd_dq: two launches on the same inputs differ")
            dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, True,
                                        scale, lengths)
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  "flash_bwd_dkv: two launches on the same inputs differ")
            line += "; dq and dkv twice on the same inputs: equal bit for " \
                    "bit"
            del dq2, dk2, dv2
        del tols
        if label in ("train", "train fp32"):
            torch.cuda.empty_cache()
            bf16 = dtype == torch.bfloat16
            kind = "bf16" if bf16 else "fp32"
            ms = cold_ms(torch, lambda: fa.flash_attention_forward(
                q, k, v, True, scale, lengths, return_lse=True), flush,
                reps=10)
            plain = cold_ms(torch, lambda: fa.reference_attention_lse(
                q, k, v, True, scale, lengths), flush, reps=5)
            qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                          for a in (q, k, v))
            lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush, reps=10)
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True)
            do_t = dout.transpose(1, 2)
            lib_bwd = cold_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do_t, retain_graph=True), flush,
                reps=10)
            dq_ms = cold_ms(torch, lambda: fa.flash_bwd_dq(
                q, k, v, dout, lse, delta, True, scale, lengths), flush,
                reps=10)
            dq_plain = cold_ms(torch, lambda: fa.flash_bwd_dq_ref(
                q, k, v, dout, lse, delta, True, scale, lengths), flush,
                reps=5)
            dkv_ms = cold_ms(torch, lambda: fa.flash_bwd_dkv(
                q, k, v, dout, lse, delta, True, scale, lengths), flush,
                reps=10)
            dkv_plain = cold_ms(torch, lambda: fa.flash_bwd_dkv_ref(
                q, k, v, dout, lse, delta, True, scale, lengths), flush,
                reps=5)
            # this run's work: query row t attends t + 1 keys (full
            # lengths); per pair the forward does 4d flops, dq 6d (the
            # score, dO V^T, dS K) and dkv 8d (the score, dO V^T, P^T dO,
            # dS^T Q); each input read once, each output written once
            pairs = sum(min(i + 1, L) for L in lens for i in range(T))
            es = q.element_size()
            qb, kb = q.numel() * es, k.numel() * es
            stats = 2 * B * H * T * 4
            f_ms, f_by = bound(2 * qb + 2 * kb + B * H * T * 4,
                               pairs * H * 4 * d, kind)
            q_ms, q_by = bound(3 * qb + 2 * kb + stats,
                               pairs * H * 6 * d, kind)
            k_ms, k_by = bound(2 * qb + 4 * kb + stats,
                               pairs * H * 8 * d, kind)
            shape = f"B={B} T={T} H={H} K={K} d={d} causal, full lengths " \
                    f"{kind}"
            fwd = dict(max_abs_err=float((out.float() - ref.float()).abs()
                                         .max()),
                       ms=ms, plain_ms=plain, library_ms=lib, bound_ms=f_ms,
                       bound_by=f_by, shape=shape + ", writing lse")
            dq_e = dict(max_abs_err=errs[0], ms=dq_ms, plain_ms=dq_plain,
                        library_ms=lib_bwd, bound_ms=q_ms, bound_by=q_by,
                        shape=shape,
                        library="SDPA backward: dq, dk, dv together")
            dkv = dict(max_abs_err=max(errs[1:]), ms=dkv_ms,
                       plain_ms=dkv_plain, library_ms=lib_bwd,
                       bound_ms=k_ms, bound_by=k_by, shape=shape,
                       library="SDPA backward: dq, dk, dv together")
            line += f"; forward+lse ms={ms:.4f} plain_ms={plain:.4f} " \
                    f"library_ms={lib:.4f} (SDPA, causal, GQA) bound_ms=" \
                    f"{f_ms:.4f} ({f_by}); dq ms={dq_ms:.4f} plain_ms=" \
                    f"{dq_plain:.4f} bound_ms={q_ms:.4f} ({q_by}); dkv " \
                    f"ms={dkv_ms:.4f} plain_ms={dkv_plain:.4f} bound_ms=" \
                    f"{k_ms:.4f} ({k_by}); SDPA backward (dq, dk, dv " \
                    f"together) library_ms={lib_bwd:.4f}"
            if bf16:
                # the SIMT kernels on the same bf16 inputs, for comparison
                fwd["simt_ms"] = cold_ms(torch, lambda: simt_forward(
                    torch, q, k, v, True, scale, lengths), flush, reps=10)
                dq_e["simt_ms"] = cold_ms(torch, lambda: simt_dq(
                    torch, q, k, v, dout, lse, delta, True, scale,
                    lengths), flush, reps=10)
                dkv["simt_ms"] = cold_ms(torch, lambda: simt_dkv(
                    torch, q, k, v, dout, lse, delta, True, scale,
                    lengths), flush, reps=10)
                line += f"; SIMT version on the same inputs: forward+lse " \
                        f"ms={fwd['simt_ms']:.4f}, dq ms=" \
                        f"{dq_e['simt_ms']:.4f}, dkv ms=" \
                        f"{dkv['simt_ms']:.4f}"
                out_entries["fwd_tc"] = fwd
                out_entries["dq_tc"] = dict(dq_e, name="flash_bwd_dq_tc")
                out_entries["dkv_tc"] = dict(dkv, name="flash_bwd_dkv_tc")
            else:
                out_entries["fwd_simt"] = dict(fwd, name="flash_prefill")
                out_entries["dq_simt"] = dict(dq_e, name="flash_bwd_dq")
                out_entries["dkv_simt"] = dict(dkv, name="flash_bwd_dkv")
            del o_lib, qt, kt, vt
        print(line, flush=True)
        del q, k, v, dout, out, ref, dq, dk, dv, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()
    return tuple(out_entries[key] for key in ("fwd_tc", "dq_tc", "dkv_tc",
                                              "fwd_simt", "dq_simt",
                                              "dkv_simt"))


def kernel_ce(torch, F, flush):
    """The fused softmax-CE forward and backward kernels against their
    plain versions at the train shape (N=4096 rows, V=32000, bf16), rows
    that are not 16-byte aligned (the scalar path) and fp32. Returns the
    forward and backward entries."""
    from mxnet_tpu_torch.kernels.fused_ce import (ce_bwd, ce_bwd_ref,
                                                  ce_fwd, ce_fwd_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cases = (("train", TRAIN_ROWS, 32000, torch.bfloat16),
             ("unaligned rows", 37, 1030, torch.bfloat16),
             ("fp32", 64, 1024, torch.float32))
    fwd_entry = bwd_entry = None
    for label, N, V, dtype in cases:
        # logits of a random net's scale, labels anywhere in the vocab;
        # the loss cotangent is the mean's, 1/N
        x = (2 * torch.randn(N, V, generator=gen, device="cuda")).to(dtype)
        lbl = torch.randint(0, V, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        dl = torch.full((N,), 1.0 / N, device="cuda")
        loss, lse = ce_fwd(x, lbl)
        loss_ref, lse_ref = ce_fwd_ref(x, lbl)
        dx = ce_bwd(x, lbl, lse, dl)
        dx_ref = ce_bwd_ref(x, lbl, lse, dl)
        torch.cuda.synchronize()
        # lse: an fp32 sum of V exponentials in another order with
        # another exp: fp32 noise of the row's scale; loss = lse - x[label]
        xl = x.float().gather(1, lbl.long()[:, None])[:, 0]
        tol_l = FP32_NOISE * (1 + lse_ref.abs() + xl.abs())
        _, ltext = held(torch, f"ce_fwd lse {label}", lse, lse_ref,
                        FP32_NOISE * (1 + lse_ref.abs()))
        err_f, ftext = held(torch, f"ce_fwd loss {label}", loss, loss_ref,
                            tol_l)
        # dx: (p - onehot) * g in fp32 (p's fp32 noise) rounded once (one
        # bf16 step of |ref|)
        p = torch.exp(x.float() - lse[:, None])
        tol_d = FP32_NOISE * (p + 1) * dl[:, None]
        if dtype == torch.bfloat16:
            tol_d = tol_d + BF16_STEP * dx_ref.float().abs()
        del p
        err_b, btext = held(torch, f"ce_bwd {label}", dx, dx_ref, tol_d)
        line = f"[kernels] ce {label} N={N} V={V} {dtype}: lse {ltext}; " \
               f"loss {ftext}; dx {btext}"
        if label == "train":
            # a kernel reading the label off by one would fail both
            nxt = (lbl + 1) % V
            wl, _ = ce_fwd_ref(x, nxt)
            wd = ce_bwd_ref(x, nxt, lse, dl)
            line += "; label off by one: " + ", ".join((
                caught(torch, "ce_fwd label+1", wl, loss_ref, tol_l),
                caught(torch, "ce_bwd label+1", wd, dx_ref, tol_d)))
            del wl, wd
            ms = cold_ms(torch, lambda: ce_fwd(x, lbl), flush)
            plain = cold_ms(torch, lambda: ce_fwd_ref(x, lbl), flush)
            lbl64 = lbl.long()
            lib = cold_ms(torch, lambda: F.cross_entropy(
                x, lbl64, reduction="none"), flush)
            b_ms = cold_ms(torch, lambda: ce_bwd(x, lbl, lse, dl), flush)
            b_plain = cold_ms(torch, lambda: ce_bwd_ref(x, lbl, lse, dl),
                              flush)
            xr = x.detach().requires_grad_()
            y = F.cross_entropy(xr, lbl64, reduction="none")
            b_lib = cold_ms(torch, lambda: torch.autograd.grad(
                y, xr, dl, retain_graph=True), flush)
            xb = x.numel() * x.element_size()
            f_bound = bound(xb + 4 * N + 8 * N, 4 * x.numel(), "fp32")
            b_bound = bound(2 * xb + 12 * N, 4 * x.numel(), "fp32")
            line += f"; forward ms={ms:.4f} plain_ms={plain:.4f} " \
                    f"library_ms={lib:.4f} (F.cross_entropy) bound_ms=" \
                    f"{f_bound[0]:.4f} ({f_bound[1]}); backward ms=" \
                    f"{b_ms:.4f} plain_ms={b_plain:.4f} library_ms=" \
                    f"{b_lib:.4f} (its backward) bound_ms={b_bound[0]:.4f} " \
                    f"({b_bound[1]})"
            shape = f"N={N} V={V} bf16"
            fwd_entry = dict(name="ce_fwd", max_abs_err=err_f, ms=ms,
                             plain_ms=plain, library_ms=lib,
                             bound_ms=f_bound[0], bound_by=f_bound[1],
                             shape=shape)
            bwd_entry = dict(name="ce_bwd", max_abs_err=err_b, ms=b_ms,
                             plain_ms=b_plain, library_ms=b_lib,
                             bound_ms=b_bound[0], bound_by=b_bound[1],
                             shape=shape)
            del xr, y
        print(line, flush=True)
        del x, dx, dx_ref
        torch.cuda.empty_cache()
    return fwd_entry, bwd_entry


# -- phase 2c: BERT's kernels at the bert phase's shapes ----------------------

#: the bert phase (phase 6): BERT-base, B=32 x T=128, vocab 30522
BERT_B, BERT_T, BERT_VOCAB = 32, 128, 30522
BERT_ROWS = BERT_B * BERT_T           # rows of every LayerNorm


def ln_inputs(torch, gen, n, d, dtype):
    """x (n, d) with a per-row offset (so the centred variance matters),
    gamma, beta and dy."""
    x = (2 * torch.randn(n, d, generator=gen, device="cuda")
         + 4 * torch.randn(n, 1, generator=gen, device="cuda")).to(dtype)
    g = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    dy = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    return x, g, b, dy


def kernel_layernorm(torch, F, flush):
    """The LayerNorm forward (with and without its statistics) and dx
    kernels against their plain versions at BERT-base's rows (4096 x 768
    bf16), BERT-large's (4096 x 1024), transformer_base's (4096 x 512,
    fp32: its activations are fp32), ragged and unaligned rows and a row
    wider than a warp's. Returns the forward and dx entries."""
    from mxnet_tpu_torch.kernels.fused_norm import (
        layernorm_dx, layernorm_dx_ref, layernorm_fwd, layernorm_fwd_ref)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    eps = 1e-5
    bf16, f32 = torch.bfloat16, torch.float32
    cases = (("bert_base", BERT_ROWS, 768, bf16),
             ("bert_large", BERT_ROWS, 1024, bf16),
             ("transformer_base fp32", BERT_ROWS, 512, f32),
             ("ragged", 37, 768, bf16),
             ("unaligned fp32", 37, 771, f32),
             ("block per row", 37, 4096, bf16))
    fwd_entry = dx_entry = None
    for label, n, d, dtype in cases:
        x, g, b, dy = ln_inputs(torch, gen, n, d, dtype)
        out, mu, rstd = layernorm_fwd(x, g, b, eps)
        bare, no_mu, no_rstd = layernorm_fwd(x, g, b, eps, with_stats=False)
        ref, mu_ref, rstd_ref = layernorm_fwd_ref(x, g, b, eps)
        dx = layernorm_dx(x, g, mu, rstd, dy)
        dx_ref = layernorm_dx_ref(x, g, mu, rstd, dy)
        torch.cuda.synchronize()
        check(no_mu is None and no_rstd is None and torch.equal(bare, out),
              f"layernorm {label}: the forward without statistics differs")
        xs = x.float()
        mabs = xs.abs().mean(dim=-1)
        # mu: both sum d values in fp32 in another order, each in a
        # chain under 40 deep: under 2^-19 of the row's mean |x|; 2^-17
        # leaves 4x headroom and stays far under a row's own offset
        _, mtext = held(torch, f"layernorm mu {label}", mu, mu_ref,
                        2.0 ** -17 * mabs)
        # rstd: a d-term fp32 sum of squares (as rrms, rmsnorm_train)
        _, rtext = held(torch, f"layernorm rstd {label}", rstd, rstd_ref,
                        2.0 ** -16 * rstd_ref)
        # out = (x - mu) rstd g + b: mu's and rstd's error carried through
        # and the fp32 rounding of the terms, rounded once to x's dtype
        # (one bf16 step of |ref|)
        xc = (xs - mu_ref[:, None]).abs()
        tol = 2.0 ** -16 * (rstd_ref[:, None] * g.abs()
                            * (mabs[:, None] + xc) + b.abs())
        if dtype == bf16:
            tol = tol + BF16_STEP * ref.float().abs()
        err, otext = held(torch, f"layernorm {label}", out, ref, tol)
        # dx = rstd (wdy - mean(wdy) - xhat mean(wdy xhat)): two d-term
        # means in another order (fp32 noise of the terms' scale), one
        # rounding (one bf16 step of |ref|)
        r = rstd[:, None]
        xhat = (xs - mu[:, None]) * r
        wdy = dy.float() * g
        m1 = wdy.mean(dim=-1, keepdim=True)
        m2 = (wdy * xhat).mean(dim=-1, keepdim=True)
        dtol = FP32_NOISE * r * (wdy.abs() + m1.abs() + (xhat * m2).abs())
        if dtype == bf16:
            dtol = dtol + BF16_STEP * dx_ref.float().abs()
        derr, dtext = held(torch, f"layernorm_dx {label}", dx, dx_ref, dtol)
        line = f"[kernels] layernorm {label} {tuple(x.shape)} {dtype}: out " \
               f"{otext}; mu {mtext}; rstd {rtext}; dx {dtext}"
        if label == "bert_base":
            # the neighbouring row's statistics, and dx without its
            # xhat * mean(wdy xhat) term, would fail the same tolerances
            nb = ((xs - mu.roll(1)[:, None]) * rstd.roll(1)[:, None] * g
                  + b).to(dtype)
            short = (r * (wdy - m1)).to(dtype)
            line += "; wrong: " + ", ".join((
                caught(torch, "layernorm neighbour's stats", nb, ref, tol),
                caught(torch, "layernorm_dx without its xhat term", short,
                       dx_ref, dtol)))
            del nb, short
        if label in ("bert_base", "bert_large"):
            ms = cold_ms(torch, lambda: layernorm_fwd(x, g, b, eps), flush)
            bare_ms = cold_ms(torch, lambda: layernorm_fwd(
                x, g, b, eps, with_stats=False), flush)
            plain = cold_ms(torch, lambda: layernorm_fwd_ref(x, g, b, eps),
                            flush)
            gx, bx = g.to(dtype), b.to(dtype)
            lib = cold_ms(torch, lambda: F.layer_norm(x, (d,), gx, bx, eps),
                          flush)
            dms = cold_ms(torch, lambda: layernorm_dx(x, g, mu, rstd, dy),
                          flush)
            dplain = cold_ms(torch, lambda: layernorm_dx_ref(
                x, g, mu, rstd, dy), flush)
            # yardstick: the backward of F.layer_norm for x alone, its
            # forward graph built once and kept
            xr = x.detach().requires_grad_()
            y = F.layer_norm(xr, (d,), gx, bx, eps)
            dlib = cold_ms(torch, lambda: torch.autograd.grad(
                y, xr, dy, retain_graph=True), flush)
            xb = x.numel() * x.element_size()
            # each input read once, each output written once; about 8
            # fp32 operations an element forward, 10 backward
            f_ms, f_by = bound(2 * xb + 2 * d * 4 + 2 * n * 4,
                               8 * x.numel(), "fp32")
            d_ms, d_by = bound(3 * xb + d * 4 + 2 * n * 4, 10 * x.numel(),
                               "fp32")
            line += f"; forward (writing mu, rstd) ms={ms:.4f} (without " \
                    f"{bare_ms:.4f}) plain_ms={plain:.4f} library_ms=" \
                    f"{lib:.4f} (F.layer_norm) bound_ms={f_ms:.4f} " \
                    f"({f_by}); dx ms={dms:.4f} plain_ms={dplain:.4f} " \
                    f"library_ms={dlib:.4f} (F.layer_norm backward) " \
                    f"bound_ms={d_ms:.4f} ({d_by})"
            if label == "bert_base":
                shape = f"x {tuple(x.shape)} bf16"
                fwd_entry = dict(name="layernorm", max_abs_err=err, ms=ms,
                                 plain_ms=plain, library_ms=lib,
                                 bound_ms=f_ms, bound_by=f_by,
                                 shape=shape + ", writing mu and rstd",
                                 no_stats_ms=bare_ms)
                dx_entry = dict(name="layernorm_dx", max_abs_err=derr,
                                ms=dms, plain_ms=dplain, library_ms=dlib,
                                bound_ms=d_ms, bound_by=d_by,
                                shape=f"x, dy {tuple(x.shape)} bf16")
            del xr, y
        print(line, flush=True)
    return fwd_entry, dx_entry


def kernel_flash_bert(torch, F, flush):
    """The attention forward with its lse and the dq and dkv kernels at
    BERT-base's self-attention (B=32, T=128, H=K=12, d=64, full, key
    padding from lengths drawn from the seed in [64, 128], bf16) and a
    small fp32 case, against their plain versions; lengths off by one
    must fall outside the tolerances, and dq and dkv run twice must be
    equal bit for bit. Returns the "bert" times of the forward, dq and
    dkv rows."""
    from mxnet_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    main_lens = np.random.RandomState(SEED + 13).randint(
        BERT_T // 2, BERT_T + 1, BERT_B).tolist()
    cases = (("bert_base", BERT_B, BERT_T, 12, 64, main_lens,
              torch.bfloat16),
             ("small fp32", 2, 77, 2, 64, [77, 30], torch.float32))
    times = None
    for label, B, T, H, d, lens, dtype in cases:
        q, k, v, dout = (torch.randn(B, T, H, d, generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(4))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_attention_forward(q, k, v, False, scale, lengths,
                                              return_lse=True)
        ref, lse_ref = fa.reference_attention_lse(q, k, v, False, scale,
                                                  lengths)
        delta = fa.attention_delta(out, dout)
        dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, False, scale,
                             lengths)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, False, scale,
                                  lengths)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, dout, lse, delta, False, scale,
                                     lengths)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, dout, lse, delta,
                                              False, scale, lengths)
        torch.cuda.synchronize()
        # as kernel_flash_train, with every key below lengths[b] kept
        tol = attn_fwd_tol(torch, q, k, v, ref, scale, lengths, False)
        err_f, otext = held(torch, f"flash_fwd {label}", out, ref, tol)
        _, ltext = held(torch, f"flash_fwd lse {label}", lse, lse_ref,
                        FP32_NOISE * (1 + lse_ref.abs()))
        (_, terms) = attn_backward_fp32(torch, q, k, v, dout, lse, delta,
                                        scale, lengths, causal=False)
        tols = attn_bwd_tols(torch, terms, (dq_ref, dk_ref, dv_ref))
        del terms
        errs, texts = zip(*(held(torch, f"flash_{n} {label}", o, r, t)
                            for n, o, r, t in zip(
                                ("dq", "dk", "dv"), (dq, dk, dv),
                                (dq_ref, dk_ref, dv_ref), tols)))
        line = f"[kernels] flash full attention {label} B={B} T={T} H=K={H} " \
               f"d={d} lengths={lens} {dtype}: out {otext}; lse {ltext}; " \
               + "; ".join(f"{n} {t}" for n, t in zip(("dq", "dk", "dv"),
                                                      texts))
        if label == "bert_base":
            # each row seeing one key more or one fewer past its length
            wrong = []
            for off in (-1, 1):
                wl = lengths + off
                wrong.append(caught(
                    torch, f"flash_fwd lengths{off:+d}",
                    fa.reference_attention(q, k, v, False, scale, wl), ref,
                    tol))
                grads, _ = attn_backward_fp32(torch, q, k, v, dout, lse,
                                              delta, scale, wl,
                                              causal=False, terms=False)
                wrong += [caught(torch, f"flash_{n} lengths{off:+d}",
                                 w.to(dtype), r, t)
                          for n, w, r, t in zip(("dq", "dk", "dv"), grads,
                                                (dq_ref, dk_ref, dv_ref),
                                                tols)]
                del grads
            line += "; lengths off by one: " + ", ".join(wrong)
            dq2 = fa.flash_bwd_dq(q, k, v, dout, lse, delta, False, scale,
                                  lengths)
            check(torch.equal(dq, dq2),
                  "flash_bwd_dq bert: two launches on the same inputs "
                  "differ")
            dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, False,
                                        scale, lengths)
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  "flash_bwd_dkv bert: two launches on the same inputs "
                  "differ")
            del dq2, dk2, dv2
            ms = cold_ms(torch, lambda: fa.flash_attention_forward(
                q, k, v, False, scale, lengths, return_lse=True), flush)
            simt = cold_ms(torch, lambda: simt_forward(
                torch, q, k, v, False, scale, lengths), flush)
            dq_simt = cold_ms(torch, lambda: simt_dq(
                torch, q, k, v, dout, lse, delta, False, scale, lengths),
                flush)
            dkv_simt = cold_ms(torch, lambda: simt_dkv(
                torch, q, k, v, dout, lse, delta, False, scale, lengths),
                flush)
            plain = cold_ms(torch, lambda: fa.reference_attention_lse(
                q, k, v, False, scale, lengths), flush, reps=10)
            dq_ms = cold_ms(torch, lambda: fa.flash_bwd_dq(
                q, k, v, dout, lse, delta, False, scale, lengths), flush)
            dkv_ms = cold_ms(torch, lambda: fa.flash_bwd_dkv(
                q, k, v, dout, lse, delta, False, scale, lengths), flush)
            dq_plain = cold_ms(torch, lambda: fa.flash_bwd_dq_ref(
                q, k, v, dout, lse, delta, False, scale, lengths), flush,
                reps=10)
            dkv_plain = cold_ms(torch, lambda: fa.flash_bwd_dkv_ref(
                q, k, v, dout, lse, delta, False, scale, lengths), flush,
                reps=10)
            # SDPA with the same key padding as a boolean (B, 1, 1, S) mask
            keep = (torch.arange(T, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                          for a in (q, k, v))
            lib = cold_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep), flush)
            o_lib = F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=keep)
            do_t = dout.transpose(1, 2)
            lib_bwd = cold_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do_t, retain_graph=True), flush)
            # this run's work: every query row attends lengths[b] keys;
            # per pair 4d flops forward, 6d dq, 8d dkv
            pairs = sum(T * L for L in lens)
            qb = q.numel() * q.element_size()
            stats = 2 * B * H * T * 4
            f_ms, f_by = bound(4 * qb + B * H * T * 4, pairs * H * 4 * d,
                               "bf16")
            q_ms, q_by = bound(5 * qb + stats, pairs * H * 6 * d, "bf16")
            k_ms, k_by = bound(6 * qb + stats, pairs * H * 8 * d, "bf16")
            line += f"; forward+lse ms={ms:.4f} plain_ms={plain:.4f} " \
                    f"library_ms={lib:.4f} (SDPA, key-padding mask) " \
                    f"bound_ms={f_ms:.4f} ({f_by}); dq ms={dq_ms:.4f} " \
                    f"plain_ms={dq_plain:.4f} bound_ms={q_ms:.4f} ({q_by});" \
                    f" dkv ms={dkv_ms:.4f} plain_ms={dkv_plain:.4f} " \
                    f"bound_ms={k_ms:.4f} ({k_by}); SDPA backward (dq, dk, " \
                    f"dv together) library_ms={lib_bwd:.4f}; SIMT version " \
                    f"on the same inputs: forward+lse ms={simt:.4f}, dq " \
                    f"ms={dq_simt:.4f}, dkv ms={dkv_simt:.4f}; dq and dkv " \
                    f"twice: equal bit for bit"
            shape = f"B={B} T={T} H=K={H} d={d} full, lengths " \
                    f"{min(lens)}-{max(lens)} bf16"
            times = (dict(ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=f_ms, bound_by=f_by, max_abs_err=err_f,
                          simt_ms=simt, shape=shape + ", writing lse"),
                     dict(ms=dq_ms, plain_ms=dq_plain, library_ms=lib_bwd,
                          bound_ms=q_ms, bound_by=q_by, max_abs_err=errs[0],
                          simt_ms=dq_simt, shape=shape),
                     dict(ms=dkv_ms, plain_ms=dkv_plain, library_ms=lib_bwd,
                          bound_ms=k_ms, bound_by=k_by,
                          max_abs_err=max(errs[1:]), simt_ms=dkv_simt,
                          shape=shape))
            del o_lib, qt, kt, vt
        print(line, flush=True)
        del q, k, v, dout, out, ref, dq, dk, dv, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()
    return times


# -- phase 3: serve -----------------------------------------------------------

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


def logits_vs_plain(torch, F, net, kern, seq, label):
    """Hold the kernel path's last-position logits `kern` of token
    sequence `seq` against the plain versions in bf16 and in fp32. Both
    bf16 paths round 32 layers of activations at different points (fused
    norm, fp32 P in attention, padded or chunked vs whole prompt): the
    kernel path may stand no further from the fp32 result than twice the
    plain bf16 path does. Returns (fp32 logits, tolerance)."""
    seq = np.asarray(seq, np.int64)
    with torch.inference_mode():
        plain = plain_prefill_logits(torch, F, net, seq, torch.bfloat16)
        truth = plain_prefill_logits(torch, F, net, seq, torch.float32)
    err = max_err(kern, plain)
    err_kernel, err_plain = max_err(kern, truth), max_err(plain, truth)
    cos = float(F.cosine_similarity(kern.float(), plain.float(), dim=0))
    tol = 2 * err_plain
    check(bool(torch.isfinite(kern).all()) and err_kernel <= tol,
          f"{label}: kernel path {err_kernel} from fp32 > tol {tol}")
    print(f"{label}, max|logit| {float(truth.abs().max()):.4g}: kernel vs "
          f"plain bf16 max_abs_err={err:.4g} cosine={cos:.6f}; from fp32: "
          f"kernel {err_kernel:.4g}, plain {err_plain:.4g}, tol {tol:.4g}; "
          f"argmax kernel/plain/fp32 {int(kern.float().argmax())}/"
          f"{int(plain.float().argmax())}/{int(truth.argmax())}", flush=True)
    return truth, tol


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
        "mxtt_flash_fwd_tc": cfg.num_layers * prefills,
        "mxtt_paged_decode": cfg.num_layers * ticks}, "serve")

    # request 0's prefill: kernel path (scratch block table, so the pool
    # is untouched) against the plain versions on the unpadded prompt
    p0 = prompts[0]
    ids = np.zeros((1, MAX_PROMPT), np.int64)
    ids[0, :len(p0)] = p0
    i32 = dict(dtype=torch.int32, device="cuda")
    kern = server.programs["prefill"](
        server._params, server.cache.pages,
        torch.zeros(MAX_LEN // BLOCK_SIZE, **i32),
        torch.from_numpy(ids).cuda(), torch.tensor([len(p0)], **i32),
        torch.tensor([0], **i32))[0]
    logits_vs_plain(torch, F, net, kern, p0,
                    f"[serve] request 0 prefill logits ({len(p0)} tokens)")
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
        "mxtt_flash_fwd_tc": cfg.num_layers * prefills,
        "mxtt_paged_decode_q8": cfg.num_layers * ticks}, "serve int8")
    greedy = [i for i in range(N_REQUESTS) if i % 4 != 3]
    same = [reqs[i].output_tokens[0] == first_bf16[i] for i in greedy]
    check(all(same), f"serve int8: first tokens differ from the bf16 "
                     f"server's in requests "
                     f"{[i for i, ok in zip(greedy, same) if not ok]}")
    print(f"[serve int8] first token of all {len(greedy)} greedy requests "
          f"equal to the bf16 server's", flush=True)
    return counts


# -- phase 3b: prefix cache, chunked prefill, speculation ---------------------

PREFIX_LEN, CHUNK, SPEC_K = 392, 256, 4


def serve_spec(torch, F, net):
    """Llama-3-8B behind `prefix_cache=True, prefill_chunk_tokens=256,
    speculative=4`, 16 requests of 32 new tokens (every fourth sampled):
    a 392-token prefix P (24 full blocks and half of one) whose prefill
    completes before the rest arrive; six extensions P + 16-112 tokens,
    each sharing P's full blocks and forking its tail block by
    copy-on-write; P again, whose prefill the warm path skips; and eight
    others of 33-512 tokens, the first exactly 512 (two chunks). Exact
    launch counts (window kernel 32 per chunk and per verify tick, paged
    decode 32 per decode tick, no one-shot prefill); prefix hits,
    copy-on-write copies, the skipped prefill and a verify tick; the last
    logits of an extension's chunk, of the 512-token prompt's second
    chunk and of the repeat's warm tick against the plain versions; the
    extension's also against a server without the prefix cache, and
    servers broken on purpose (BREAKAGES) must fail both checks. Returns
    the launch counts."""
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.serving import InferenceServer

    cfg = net.cfg
    L, V = cfg.num_layers, cfg.vocab_size
    server = InferenceServer(net, batch_slots=BATCH_SLOTS,
                             block_size=BLOCK_SIZE, max_len=MAX_LEN,
                             max_prompt_len=MAX_PROMPT, prefix_cache=True,
                             prefill_chunk_tokens=CHUNK, speculative=SPEC_K)
    rs = np.random.RandomState(SEED + 7)
    # P repeats its first half: its last bigram occurred before, so the
    # n-gram proposer drafts for P and for its repeat
    half = rs.randint(0, V, PREFIX_LEN // 2)
    P = np.concatenate([half, half])
    prompts = [P] + [np.concatenate([P, rs.randint(0, V, n)])
                     for n in rs.randint(16, 113, 6)] + [P.copy()]
    prompts += [rs.randint(0, V, MAX_PROMPT)] + [
        rs.randint(0, V, n) for n in rs.randint(33, MAX_PROMPT + 1, 7)]
    server.submit(rs.randint(0, V, 8), max_new_tokens=2)    # warm-up
    server.run()

    # each request's chunk count and the logits of its last chunk
    finals, chunks = {}, {}
    one_chunk = server._prefill_chunk

    def recording_chunk(slot, budget):
        req = server._slot_req[slot]
        n = one_chunk(slot, budget)
        chunks[req.id] = chunks.get(req.id, 0) + 1
        if not server._prefilling[slot]:
            finals[req.id] = server._last_logits[slot].clone()
        return n
    server._prefill_chunk = recording_chunk

    def submit(i):
        hot = i % 4 == 3
        return server.submit(
            prompts[i], max_new_tokens=NEW_TOKENS,
            temperature=0.8 if hot else 0.0, top_k=50 if hot else 0,
            top_p=0.9 if hot else 0.0, seed=i)

    _build.reset_launch_counts()
    calls0 = {n: p.calls for n, p in server.programs.items()}
    st0 = server.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(0)]
    while not reqs[0].output_tokens:      # P prefilled and registered
        server.step()
    reqs += [submit(i) for i in range(1, N_REQUESTS)]
    ext, repeat, long_ = reqs[1], reqs[7], reqs[8]
    warm = None
    while server._pending():
        server.step()
        slot = next((s for s, r in enumerate(server._slot_req)
                     if r is repeat), None)
        if warm is None and slot is not None:
            # the repeat's first tick re-fed P's last token: the logits
            # that follow P and what that tick emitted
            warm = (server._last_logits[slot].clone(),
                    list(repeat.output_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    calls = {n: p.calls - calls0[n] for n, p in server.programs.items()}
    st = server.stats()
    d = {k: st[k] - st0[k] for k in (
        "kv_prefix_hits", "kv_cow_copies", "prefills_skipped",
        "spec_tokens_accepted", "spec_tokens_rejected")}

    for r in reqs:
        check(r.status == "ok" and len(r.output_tokens) == NEW_TOKENS
              and all(0 <= t < V for t in r.output_tokens),
              f"serve spec: request {r.id}: status {r.status}, tokens "
              f"{r.output_tokens}")
    check(calls["prefill"] == 0, "serve spec: a one-shot prefill ran")
    fwd = calls["prefill_chunk"] + calls["decode"] + calls["verify"]
    expect_launches(counts, {
        "mxtt_rmsnorm": (2 * L + 1) * fwd,
        "mxtt_paged_window": L * (calls["prefill_chunk"] + calls["verify"]),
        "mxtt_paged_decode": L * calls["decode"]}, "serve spec")
    check(d["kv_prefix_hits"] >= 7 and d["kv_cow_copies"] >= 1
          and d["prefills_skipped"] == 1 and calls["verify"] >= 1,
          f"serve spec: prefix hits, copy-on-write copies, skipped "
          f"prefills or verify ticks short: {d}, {calls}")
    server.cache.check()
    check(st["kv_used_blocks"] == 0, "serve spec: blocks still held")
    proposed = d["spec_tokens_accepted"] + d["spec_tokens_rejected"]
    n_tok = sum(len(r.output_tokens) for r in reqs)
    print(f"[serve spec] {N_REQUESTS} requests (prefix {PREFIX_LEN} tokens, "
          f"6 extensions of {min(map(len, prompts[1:7]))}-"
          f"{max(map(len, prompts[1:7]))}, 1 repeat, 8 others of "
          f"{min(map(len, prompts[8:]))}-{max(map(len, prompts[8:]))}; "
          f"{NEW_TOKENS} new each, 4 sampled), chunk {CHUNK}, k {SPEC_K}: "
          f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s, "
          f"{calls['prefill_chunk']} prefill chunks, {calls['decode']} "
          f"decode and {calls['verify']} verify ticks, prefix hits "
          f"{d['kv_prefix_hits']}, copy-on-write copies "
          f"{d['kv_cow_copies']}, prefills skipped "
          f"{d['prefills_skipped']}, drafts accepted "
          f"{d['spec_tokens_accepted']} of {proposed} (draft accept rate "
          f"{d['spec_tokens_accepted'] / max(proposed, 1):.3f}), "
          f"preemptions {server.preemptions}", flush=True)

    # one chunk from position 392 proves the extension adopted P's blocks
    # (cold, its 408+ tokens would take two)
    check(chunks.get(ext.id) == 1 and chunks.get(long_.id) == 2
          and repeat.id not in chunks and warm is not None,
          f"serve spec: chunks {chunks}, warm tick seen {warm is not None}")
    truth, tol = logits_vs_plain(
        torch, F, net, finals[ext.id], prompts[1],
        f"[serve spec] copy-on-write extension ({len(prompts[1])} tokens, "
        f"{PREFIX_LEN} shared) chunk logits")
    # the same prompt through a server without the prefix cache: its
    # chunks compute every row with the same per-row arithmetic, so the
    # shared path may differ from it by one bf16 step of the largest logit
    # at most; a server broken on purpose must fail both that and the
    # yardstick against fp32
    cold = chunk_logits(torch, net, None, prompts[1])
    tight = BF16_STEP * float(cold.float().abs().max())
    same = max_err(finals[ext.id], cold)
    broken = {b: chunk_logits(torch, net, P, prompts[1], b)
              for b in BREAKAGES}
    print(f"[serve spec] extension chunk logits vs a server without the "
          f"prefix cache: max_abs_err={same:.4g} (tol {tight:.4g}); broken "
          f"on purpose: " + ", ".join(
              f"{b} {max_err(w, cold):.4g} from it and {max_err(w, truth):.4g}"
              f" from fp32 (tol {tol:.4g}: "
              f"{'caught' if max_err(w, truth) > tol else 'passes'})"
              for b, w in broken.items()), flush=True)
    check(same <= tight and all(max_err(w, cold) > tight
                                and max_err(w, truth) > tol
                                for w in broken.values()),
          "serve spec: the shared extension differs from the cold one, or "
          "a broken server passes")
    logits_vs_plain(torch, F, net, finals[long_.id], prompts[8],
                    f"[serve spec] {MAX_PROMPT}-token prompt, second chunk "
                    f"logits")
    logits_vs_plain(torch, F, net, warm[0], np.concatenate([P, warm[1]]),
                    f"[serve spec] warm repeat ({PREFIX_LEN} tokens, prefill "
                    f"skipped, {len(warm[1])} tokens emitted) warm tick "
                    f"logits")
    return counts


#: ways to break the extension's admission, each of which the direct logit
#: check must catch: the fork's tail rows 384-391 copied from P's first
#: block (a stale tail row), the fork's table reading P's block 6 for
#: positions 80-95 (a wrongly adopted block), the chunk starting 8 rows
#: past the shared length (rows 392-399 never written)
BREAKAGES = ("stale tail rows", "wrong block", "shared_len + 8")


def chunk_logits(torch, net, P, prompt, breakage=None):
    """Last-chunk logits of `prompt` from a fresh chunked server: without
    the prefix cache when P is None; else with it, P resident first and
    the admission of `prompt` (P + a tail) broken as `breakage` names (one
    of BREAKAGES)."""
    from mxnet_tpu_torch.serving import InferenceServer

    server = InferenceServer(net, batch_slots=BATCH_SLOTS,
                             block_size=BLOCK_SIZE, max_len=MAX_LEN,
                             max_prompt_len=MAX_PROMPT,
                             prefix_cache=P is not None,
                             prefill_chunk_tokens=CHUNK)
    if P is not None:
        r0 = server.submit(P, max_new_tokens=2)
        while not r0.output_tokens:
            server.step()
    if breakage == "stale tail rows":
        copy, first = server._copy_block, int(server.cache.block_tables[0, 0])
        server._copy_block = lambda src, dst: copy(first, dst)
    one_chunk, out = server._prefill_chunk, []

    def broken_chunk(slot, budget):
        if not out:
            out.append(None)
            if breakage == "wrong block":
                bt = server.cache.block_tables[slot]
                bt[5] = bt[6]
            elif breakage == "shared_len + 8":
                server._prefill_pos[slot] += 8
        n = one_chunk(slot, budget)
        if not server._prefilling[slot]:
            out.append(server._last_logits[slot].clone())
        return n
    server._prefill_chunk = broken_chunk
    server.submit(prompt, max_new_tokens=1)
    while len(out) < 2:
        server.step()
    return out[-1]


class OracleProposer:
    """Drafts a known continuation: for a context that is a prefix of one
    of `streams` (prompt + the plain server's greedy tokens), the k + 1
    tokens that follow it there; nothing otherwise."""

    def __init__(self, k, streams):
        self.k = k
        self.streams = streams

    def propose(self, tokens):
        n = len(tokens)
        for s in self.streams:
            if len(s) > n and np.array_equal(s[:n], tokens):
                return s[n:n + self.k + 1]
        return np.zeros(0, np.int64)


def serve_oracle(torch, F, net, prompts):
    """Accepted drafts on the card: 8 greedy requests (the serve phase's
    prompts cut to 128 tokens, 32 new each) through the plain server,
    keeping the logits each tick leaves for the next token, then through
    a speculative server whose proposer drafts the plain server's tokens.
    Drafts must be accepted and some tick must emit more than one token
    of a row. The logits of the first such verify tick, on a row that
    has emitted the plain server's tokens, are held against the plain
    versions (logits_vs_plain), whose tolerance is the fixed yardstick:
    twice the plain bf16 path's distance from fp32. Wherever a row of
    the speculative server has emitted the plain server's tokens so far,
    its logits after a tick are held against the plain server's for the
    same context: `noise`, the largest difference, may not exceed that
    yardstick. A greedy token may differ from the plain server's only
    where the plain top-2 margin is under 2 noise (the gap between two
    logits moves by at most twice their largest change)."""
    from mxnet_tpu_torch.serving import InferenceServer

    geo = dict(batch_slots=BATCH_SLOTS, block_size=BLOCK_SIZE,
               max_len=MAX_LEN, max_prompt_len=MAX_PROMPT)
    short = [p[:128] for p in prompts[:BATCH_SLOTS]]
    plain = InferenceServer(net, **geo)
    preqs = [plain.submit(p, max_new_tokens=NEW_TOKENS) for p in short]
    ref = {}                  # (row, tokens emitted) -> next-token logits
    while plain._pending():
        plain.step()
        for slot, r in enumerate(plain._slot_req):
            if r is not None:
                ref[preqs.index(r), len(r.output_tokens)] = \
                    plain._last_logits[slot].float()
    streams = [np.concatenate([p, np.asarray(r.output_tokens, p.dtype)])
               for p, r in zip(short, preqs)]

    spec = InferenceServer(net, speculative=OracleProposer(SPEC_K, streams),
                           **geo)
    sreqs = [spec.submit(p, max_new_tokens=NEW_TOKENS) for p in short]
    multi, noise, compared, verified = 0, 0.0, 0, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while spec._pending():
        before = [len(r.output_tokens) for r in sreqs]
        spec.step()
        multi += sum(len(r.output_tokens) - b > 1
                     for r, b in zip(sreqs, before))
        for slot, r in enumerate(spec._slot_req):
            if r is None:
                continue
            i, n = sreqs.index(r), len(r.output_tokens)
            on_track = r.output_tokens == preqs[i].output_tokens[:n]
            if verified is None and on_track and n - before[i] > 1:
                # a verify tick that accepted drafts left these logits
                verified = (i, n, spec._last_logits[slot].clone())
            if (i, n) in ref and on_track:
                noise = max(noise, max_err(spec._last_logits[slot],
                                           ref[i, n]))
                compared += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = spec.stats()
    proposed = st["spec_tokens_accepted"] + st["spec_tokens_rejected"]
    check(st["spec_tokens_accepted"] > 0 and multi > 0 and compared > 0
          and verified is not None,
          f"serve oracle: {st['spec_tokens_accepted']} of {proposed} drafts "
          f"accepted, {multi} multi-token row-ticks, {compared} logits "
          f"compared, a verify tick on the plain server's tokens "
          f"{'seen' if verified else 'not seen'}")
    i, n, logits = verified
    _, tol = logits_vs_plain(
        torch, F, net, logits, np.concatenate(
            [short[i], np.asarray(preqs[i].output_tokens[:n], np.int64)]),
        f"[serve oracle] request {sreqs[i].id} verify tick logits after "
        f"{n} tokens, drafts accepted")
    check(noise <= tol,
          f"serve oracle: logits {noise:.4g} from the plain server's, "
          f"beyond the yardstick {tol:.4g}")
    same, firsts = 0, []
    for i, (a, b) in enumerate(zip(preqs, sreqs)):
        check(b.status == "ok" and len(b.output_tokens) == NEW_TOKENS,
              f"serve oracle: request {b.id}: status {b.status}")
        j = next((j for j in range(NEW_TOKENS)
                  if a.output_tokens[j] != b.output_tokens[j]), NEW_TOKENS)
        if j == NEW_TOKENS:
            same += 1
            continue
        # token 0 comes from one prefill program in both servers: it has
        # no margin to flip
        top2 = ref[i, j].topk(2).values if (i, j) in ref else None
        m = float(top2[0] - top2[1]) if top2 is not None else math.inf
        check(m < 2 * noise,
              f"serve oracle: request {b.id} token {j} differs from the "
              f"plain server's at a top-2 margin {m:.4g} >= 2 x {noise:.4g}")
        firsts.append(f"{j} (margin {m:.3g})")
    print(f"[serve oracle] {len(sreqs)} greedy requests, {NEW_TOKENS} new "
          f"each, oracle drafts k {SPEC_K}: {st['verify_calls']} verify and "
          f"{st['decode_calls']} decode ticks in {wall:.2f} s, drafts "
          f"accepted {st['spec_tokens_accepted']} of {proposed} (draft "
          f"accept rate {st['draft_accept_rate']:.3f}), {multi} row-ticks "
          f"emitted more than one token; logits vs the plain server's on "
          f"{compared} equal contexts: max_abs_err={noise:.4g} (yardstick "
          f"{tol:.4g}); {same} of "
          f"{len(sreqs)} requests equal to the plain server's tokens, the "
          f"rest first differ at token {', '.join(firsts) or '-'}",
          flush=True)


# -- phase 4: generate --------------------------------------------------------

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
                                 "mxtt_flash_fwd_tc": L,
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
                             "mxtt_flash_fwd_tc": L,
                             "mxtt_contig_decode": L * (new_b - 1)},
                    "generate_beam")
    return runs


# -- phase 5: train -----------------------------------------------------------

#: gradients within one bf16 step (relative L2) count as agreeing whatever
#: the plain path's own distance from fp32: below the dtype's resolution
GRAD_FLOOR = 2.0 ** -7


def rel_l2(torch, a, b):
    """||a - b|| / ||b|| in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def hold_gradients(torch, label, names, g_k, g_p, g_32, loss_k, loss_32):
    """Per parameter: the kernel path's gradient (g_k) within
    max(GRAD_FLOOR, 2 x the plain path's relative L2 distance) of the
    fp32 copy's (g_32); g_p is the plain versions' in the net's own
    dtype. An attention's key-projection bias has an exact gradient of
    zero (adding one value to every key's score leaves the softmax
    unchanged), so its computed gradients are rounding noise and have no
    relative distance: its distances are taken relative to the norm of
    the same attention's value-projection bias gradient, a sum over the
    same key rows of the same backward."""
    ref = dict(zip(names, g_32))
    rows = []
    for n, a, b, c in zip(names, g_k, g_p, g_32):
        if n.endswith("key_proj.bias"):
            scale = ref[n[:-len("key_proj.bias")] + "value_proj.bias"] \
                .float().norm().clamp(min=1e-30)
            rk, rp = (float((x.float() - c.float()).norm() / scale)
                      for x in (a, b))
        else:
            rk, rp = rel_l2(torch, a, c), rel_l2(torch, b, c)
        rows.append((rk / max(GRAD_FLOOR, 2 * rp), n, rk, rp))
    worst = sorted(rows, reverse=True)
    bad = [r for r in rows if r[0] > 1]
    check(not bad, f"{label}: gradients beyond max(floor, 2 x plain) from "
                   "fp32: " + ", ".join(f"{n} {rk:.4g} (plain {rp:.4g})"
                                        for _, n, rk, rp in bad))
    print(f"[{label}] one step's gradients, relative L2 from the fp32 "
          f"copy's plain-path gradients, per parameter: kernel path within "
          f"max({GRAD_FLOOR:.4g}, 2 x the plain path's) for all "
          f"{len(rows)}; loss kernel {float(loss_k):.5f}, fp32 "
          f"{float(loss_32):.5f}; closest to the bound: " + ", ".join(
              f"{n} {rk:.4g} (plain {rp:.4g})" for _, n, rk, rp in worst[:4])
          + f"; kernel-path distances {min(r[2] for r in rows):.4g}-"
          f"{max(r[2] for r in rows):.4g}, plain-path "
          f"{min(r[3] for r in rows):.4g}-{max(r[3] for r in rows):.4g}, "
          f"largest ratio to the bound {worst[0][0]:.3f}", flush=True)


@contextlib.contextmanager
def plain_kernels():
    """The kernel entry points the training paths call (RMSNorm,
    LayerNorm, attention, softmax CE), swapped for their plain versions
    while the block runs: torch autograd then differentiates the plain
    forward. The models and the loss look each up in its module at call
    time."""
    from mxnet_tpu_torch.kernels import fused_ce, fused_norm
    from mxnet_tpu_torch.kernels import flash_attention as fa

    def attention(q, k, v, causal=True, scale=None, lengths=None):
        return fa.reference_attention(q, k, v, causal, scale, lengths)

    def softmax_ce(x, labels):
        return fused_ce.ce_fwd_ref(x, labels)[0]
    swaps = ((fused_norm, "rmsnorm", fused_norm.rmsnorm_ref),
             (fused_norm, "layernorm", fused_norm.layernorm_ref),
             (fa, "flash_attention", attention),
             (fused_ce, "softmax_ce", softmax_ce))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


#: an fp32 net's gradients through the kernels against its plain path's:
#: both fp32, so they differ by reassociation alone (about 1e-6 relative
#: per op; 2^-12 leaves room for a deep net's growth of it)
FP32_GRAD_TOL = 2.0 ** -12


def grads_three_ways(torch, label, step, step32, gen, batch, per_step,
                     per_step32=None):
    """One step's gradients through the kernels (exact launch counts),
    through the plain versions in the net's dtype and through the plain
    versions of an fp32 copy of the same weights, the dropout generator
    (if the net has one) reseeded before each so that all three draw the
    same masks; held per parameter by `hold_gradients`. With
    `per_step32`, the fp32 copy also runs through the kernels (their fp32
    route) with those exact launch counts, its gradients within
    FP32_GRAD_TOL of the plain path's per parameter; returns that run's
    launch counts."""
    def reseed():
        if gen is not None:
            gen.manual_seed(SEED)
    from mxnet_tpu_torch.kernels import _build
    net, net32 = step.net, step32.net
    _build.reset_launch_counts()
    reseed()
    loss_k, g_k = step.loss_and_grads(*batch)
    torch.cuda.synchronize()
    expect_launches(_build.launch_counts(), per_step, f"{label} gradients")
    names = [n for n, _ in net.named_parameters()]
    params = list(net.parameters())
    with torch.no_grad():
        for p32, p in zip(net32.parameters(), params):
            p32.copy_(p)
    _build.reset_launch_counts()
    with plain_kernels():
        reseed()
        g_p = torch.autograd.grad(step.loss_of(*batch), params)
        reseed()
        loss_32 = step32.loss_of(*batch)
        g_32 = torch.autograd.grad(loss_32, list(net32.parameters()))
    torch.cuda.synchronize()
    expect_launches(_build.launch_counts(), {}, f"{label} plain paths")
    hold_gradients(torch, label, names, [g.float() for g in g_k],
                   [g.float() for g in g_p], g_32, loss_k, loss_32.detach())
    del g_k, g_p
    counts32 = None
    if per_step32 is not None:
        _build.reset_launch_counts()
        reseed()
        loss_32k, g_32k = step32.loss_and_grads(*batch)
        torch.cuda.synchronize()
        counts32 = _build.launch_counts()
        expect_launches(counts32, per_step32, f"{label} fp32 kernels")
        dist = sorted((rel_l2(torch, a, c), n)
                      for n, a, c in zip(names, g_32k, g_32))
        check(dist[-1][0] <= FP32_GRAD_TOL,
              f"{label} fp32 kernels: {dist[-1][1]} gradient "
              f"{dist[-1][0]:.4g} relative L2 from the plain path's "
              f"(> {FP32_GRAD_TOL:.4g})")
        print(f"[{label}] the fp32 copy through the kernels (SIMT "
              f"attention): loss {float(loss_32k):.6f} (plain "
              f"{float(loss_32):.6f}); every gradient within "
              f"{FP32_GRAD_TOL:.4g} relative L2 of the plain path's, "
              f"largest {dist[-1][0]:.4g} ({dist[-1][1]})", flush=True)
        del g_32k
    del g_32
    torch.cuda.empty_cache()
    return counts32


def train_breakdown(torch, step, args, wall, label="train"):
    """One step's card time by kernel family (torch.profiler): the
    forward and backward (`loss_and_grads(*args)`) split by kernel, the
    update (`apply_update`) as the optimizer's; the card's idle share of
    `wall`, the median step's wall time (host clock, no profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # (part of the CUDA kernel's name, family)
    fam_of = (("rmsnorm_dx_kernel", "rmsnorm_dx"),
              ("rmsnorm_kernel", "rmsnorm"),
              ("layernorm_dx_kernel", "layernorm_dx"),
              ("layernorm_kernel", "layernorm"),
              ("flash_bwd_dq_kernel", "flash_bwd_dq"),
              ("flash_bwd_dq_tc_kernel", "flash_bwd_dq_tc"),
              ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
              ("flash_bwd_dkv_tc_kernel", "flash_bwd_dkv_tc"),
              ("flash_prefill_kernel", "flash_fwd"),
              ("flash_fwd_tc_kernel", "flash_fwd_tc"),
              ("ce_fwd_kernel", "ce_fwd"), ("ce_bwd_kernel", "ce_bwd"))

    def busy(fn, split):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        fam = {}
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CPU:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            name = ev.key.lower()
            key = "optimizer (elementwise)"
            if split:
                key = next((k for part, k in fam_of if part in name), None)
                if key is None:
                    key = "cuBLAS" if any(w in name for w in (
                        "gemm", "nvjet", "cutlass", "xmma")) \
                        else "elementwise and copies"
            fam[key] = fam.get(key, 0.0) + us / 1e3
        return out, fam

    (_, grads), fam = busy(lambda: step.loss_and_grads(*args), True)
    _, fam_opt = busy(lambda: step.apply_update(grads), False)
    fam.update(fam_opt)
    total = sum(fam.values())
    if total <= 0:
        print(f"[{label}] one step: wall {wall:.1f} ms; card busy time not "
              f"measured (torch.profiler recorded no device time)",
              flush=True)
        return
    parts = ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(fam.items(), key=lambda kv: -kv[1]))
    print(f"[{label}] one step: wall {wall:.1f} ms (median of steps 2-5, "
          f"host clock); card busy {total:.1f} ms (one more step under "
          f"torch.profiler) = {100 * total / wall:.1f}% of it (idle "
          f"{100 * max(0.0, 1 - total / wall):.1f}%); busy ms by family: "
          f"{parts}", flush=True)


def train_phase(torch, F, card):
    """Llama-3-8B at full width cut to TRAIN_LAYERS layers (bf16, random
    weights from the seed) trained by `FusedTrainStep` with AdamW (lr
    3e-4, wd 0.1; examples/llama_train.py's defaults) on one batch of
    B=2 x T=2048 tokens from the seed, the loss through
    `SoftmaxCrossEntropyLoss`'s fused route. One step's gradients through
    the kernels (G_k) are held per parameter against the same net's
    plain-version gradients (torch autograd, G_p) and an fp32 copy's
    (G_32): rel_l2(G_k, G_32) <= max(GRAD_FLOOR, 2 rel_l2(G_p, G_32)).
    Then five steps: finite, strictly falling losses and exact launch
    counts per step; train tokens/s over steps 2-5; one more step under
    the profiler. Returns the five steps' launch counts."""
    from mxnet_tpu_torch import gluon, optimizer
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from mxnet_tpu_torch.parallel import FusedTrainStep

    L, B, T = TRAIN_LAYERS, TRAIN_B, TRAIN_T
    torch.cuda.reset_peak_memory_stats()
    net = get_model("llama_3_8b", device="cuda", num_layers=L)
    cfg = net.cfg
    V = cfg.vocab_size
    n_params = sum(p.numel() for p in net.parameters())
    tok = torch.from_numpy(np.random.RandomState(SEED + 11).randint(
        0, V, (B, T + 1))).cuda()
    x, y = tok[:, :-1], tok[:, 1:]
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    step = FusedTrainStep(net, lambda lg, lbl: ce(lg.reshape(-1, V),
                                                  lbl.reshape(-1)),
                          optimizer.AdamW(learning_rate=3e-4, wd=0.1))
    print(f"[train] llama_3_8b vocab={V} D={cfg.hidden_size} "
          f"I={cfg.intermediate_size} layers={L} (cut from 32: Adam's 12 "
          f"bytes a parameter for all 7.24 B are 87 GB) heads="
          f"{cfg.num_heads}/{cfg.num_kv_heads} {cfg.dtype}: "
          f"{n_params / 1e9:.2f} B random parameters; AdamW lr 3e-4 wd "
          f"0.1; batch B={B} T={T}", flush=True)
    # bf16 at d = 128: the tensor-core forward, dq and dkv
    per_step = {"mxtt_rmsnorm": 2 * L + 1, "mxtt_rmsnorm_dx": 2 * L + 1,
                "mxtt_flash_fwd_tc": L, "mxtt_flash_bwd_dq_tc": L,
                "mxtt_flash_bwd_dkv_tc": L, "mxtt_ce_fwd": 1, "mxtt_ce_bwd": 1}
    # the fp32 copy through the kernels: the SIMT route
    per_step32 = dict(per_step, mxtt_flash_fwd_tc=0, mxtt_flash_prefill=L,
                      mxtt_flash_bwd_dq_tc=0, mxtt_flash_bwd_dq=L,
                      mxtt_flash_bwd_dkv_tc=0, mxtt_flash_bwd_dkv=L)

    # one step's gradients three ways, before any update
    net32 = LlamaForCausalLM(LlamaConfig(num_layers=L, dtype="float32"),
                             device="cuda")
    counts32 = grads_three_ways(
        torch, "train", step,
        FusedTrainStep(net32, step.loss_fn, step.optimizer), None, (x, y),
        per_step, per_step32)
    del net32

    # five steps on the batch
    _build.reset_launch_counts()
    losses, marks = [], []
    torch.cuda.synchronize()
    for _ in range(5):
        marks.append(time.perf_counter())
        losses.append(float(step(x, y)))      # the float() synchronises
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts = _build.launch_counts()
    expect_launches(counts, {k: 5 * v for k, v in per_step.items()},
                    "train 5 steps")
    check(all(math.isfinite(v) for v in losses)
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"train: losses not finite and strictly falling: {losses}")
    tps = 4 * B * T / (marks[5] - marks[1])
    peak = torch.cuda.max_memory_allocated() / 1e9
    walls = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    print(f"[train] 5 AdamW steps on one batch: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; step wall "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms; train tokens/s "
          f"over steps 2-5: {tps:.1f} ({card}); peak device memory "
          f"{peak:.2f} GB", flush=True)
    train_breakdown(torch, step, (x, y), float(np.median(walls[1:])))
    del step, net
    torch.cuda.empty_cache()
    return counts, counts32


# -- phases 6 and 7: BERT pretraining and the Transformer ---------------------

def bert_phase(torch, F, card):
    """BERT-base pretraining as bench.py's BERT leg runs it: bf16
    (`amp.convert_block`), AdamW (lr 1e-4, wd 0.01,
    multi_precision=True), `FusedTrainStep(n_model_inputs=3)` with the
    masked-MLM plus NSP loss, one batch of B=32 x T=128 from the seed
    (valid_length in [64, 128], 15% MLM mask), dropout 0.1 from a seeded
    generator. One step's gradients held three ways; five steps with
    exact launch counts per step, finite losses, the fifth below the
    first; samples/s over steps 2-5; one more step by kernel family.
    Returns the five steps' launch counts."""
    from mxnet_tpu_torch import amp, gluon, optimizer
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.parallel import FusedTrainStep

    B, T, V = BERT_B, BERT_T, BERT_VOCAB
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    net = amp.convert_block(get_model("bert_base", device="cuda", seed=SEED,
                                      dropout_generator=gen), torch.bfloat16)
    net32 = get_model("bert_base", device="cuda", seed=SEED,
                      dropout_generator=gen)
    rs = np.random.RandomState(SEED + 14)
    ids = rs.randint(4, V, (B, T))
    tok = np.zeros((B, T), np.int64)
    vlen = rs.randint(T // 2, T + 1, B).astype(np.int32)
    labels = rs.randint(4, V, (B, T))
    mask = (rs.rand(B, T) < 0.15).astype(np.float32)
    nsp = rs.randint(0, 2, B)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in (ids, tok, vlen, labels, mask, nsp))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(mlm, nsp_logits, labels_, mask_, nsp_labels):
        # bench.py's: the MLM loss averaged over the masked positions,
        # plus the NSP mean
        per = ce(mlm.reshape(-1, V), labels_.reshape(-1))
        m = mask_.reshape(-1).float()
        return (per * m).sum() / torch.clamp(m.sum(), min=1.0) \
            + ce(nsp_logits, nsp_labels).mean()

    def make_step(model):
        return FusedTrainStep(model, loss_fn, optimizer.AdamW(
            learning_rate=1e-4, wd=0.01, multi_precision=True),
            n_model_inputs=3)
    step = make_step(net)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[bert] bert_base vocab={V} units=768 hidden=3072 layers=12 "
          f"heads=12 (d=64), bf16 weights with fp32 norm gains: "
          f"{n_params / 1e6:.1f} M random parameters; AdamW lr 1e-4 wd 0.01;"
          f" dropout 0.1; batch B={B} T={T}, valid_length "
          f"{int(vlen.min())}-{int(vlen.max())}, {int(mask.sum())} MLM "
          f"positions", flush=True)
    # embed_norm, two norms a layer and mlm_norm; one attention a layer;
    # the MLM loss on the fused CE (NSP's two classes take log_softmax)
    per_step = {"mxtt_layernorm": 26, "mxtt_layernorm_dx": 26,
                "mxtt_flash_fwd_tc": 12, "mxtt_flash_bwd_dq_tc": 12,
                "mxtt_flash_bwd_dkv_tc": 12, "mxtt_ce_fwd": 1,
                "mxtt_ce_bwd": 1}
    grads_three_ways(torch, "bert", step, make_step(net32), gen, batch,
                     per_step)
    del net32

    _build.reset_launch_counts()
    gen.manual_seed(SEED)
    losses, marks = [], []
    torch.cuda.synchronize()
    for _ in range(5):
        marks.append(time.perf_counter())
        losses.append(float(step(*batch)))      # the float() synchronises
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts = _build.launch_counts()
    expect_launches(counts, {k: 5 * v for k, v in per_step.items()},
                    "bert 5 steps")
    check(all(math.isfinite(v) for v in losses) and losses[4] < losses[0],
          f"bert: losses not finite or the fifth not below the first: "
          f"{losses}")
    sps = 4 * B / (marks[5] - marks[1])
    walls = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    print(f"[bert] 5 AdamW steps on one batch: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; step wall "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms; samples/s over "
          f"steps 2-5: {sps:.1f} ({card}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    train_breakdown(torch, step, batch, float(np.median(walls[1:])), "bert")
    del step, net
    torch.cuda.empty_cache()
    return counts


def transformer_phase(torch, F, card):
    """transformer_base (bf16 weights; its activations are fp32 from the
    positional encodings on, as in the JAX package) trained by
    `FusedTrainStep(n_model_inputs=3)` with AdamW (lr 1e-4, wd 0.01) on
    one batch of B=32, src and tgt T=128, src_valid_len from the seed.
    One step's gradients held three ways, then one step: exact launch
    counts (no attention kernel: every Transformer attention carries a
    mask, as in the JAX package) and a finite loss."""
    from mxnet_tpu_torch import amp, gluon, optimizer
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.parallel import FusedTrainStep

    B, T, V = BERT_B, BERT_T, 32000
    gen = torch.Generator(device="cuda")
    net = amp.convert_block(get_model("transformer_base", device="cuda",
                                      seed=SEED, dropout_generator=gen),
                            torch.bfloat16)
    net32 = get_model("transformer_base", device="cuda", seed=SEED,
                      dropout_generator=gen)
    rs = np.random.RandomState(SEED + 15)
    src = rs.randint(0, V, (B, T))
    tgt = rs.randint(0, V, (B, T + 1))
    vlen = rs.randint(T // 2, T + 1, B).astype(np.int32)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in (src, tgt[:, :-1], vlen, tgt[:, 1:].copy()))
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def make_step(model):
        return FusedTrainStep(
            model, lambda lg, y: ce(lg.reshape(-1, V), y.reshape(-1)),
            optimizer.AdamW(learning_rate=1e-4, wd=0.01), n_model_inputs=3)
    step = make_step(net)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[transformer] transformer_base vocab={V}/{V} units=512 "
          f"hidden=2048 layers=6+6 heads=8 (d=64), bf16 weights: "
          f"{n_params / 1e6:.1f} M random parameters; AdamW lr 1e-4 wd "
          f"0.01; dropout 0.1; batch B={B} src T={T} tgt T={T}, "
          f"src_valid_len {int(vlen.min())}-{int(vlen.max())}", flush=True)
    # encoder 2 norms a layer and its final norm, decoder 3 a layer and
    # its final norm; the loss on the fused CE; attention kernels 0
    per_step = {"mxtt_layernorm": 32, "mxtt_layernorm_dx": 32,
                "mxtt_ce_fwd": 1, "mxtt_ce_bwd": 1}
    grads_three_ways(torch, "transformer", step, make_step(net32), gen,
                     batch, per_step)
    del net32
    _build.reset_launch_counts()
    gen.manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(*batch))
    wall = 1e3 * (time.perf_counter() - t0)
    counts = _build.launch_counts()
    expect_launches(counts, per_step, "transformer step")
    check(math.isfinite(loss), f"transformer: loss {loss} not finite")
    print(f"[transformer] one AdamW step: loss {loss:.5f} (ln {V} = "
          f"{math.log(V):.5f}); wall {wall:.1f} ms, the first step "
          f"(optimizer states created) ({card})", flush=True)
    del step, net
    torch.cuda.empty_cache()
    return counts


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
        for line in tc_resources():
            print(line, flush=True)

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
            entries.append(kernel_paged_window(torch, F, flush))
            rms_train, rms_dx = kernel_rmsnorm_train(torch, F, flush)
            attn_train, dq_entry, dkv_entry, fwd_simt, dq_simt, dkv_simt = \
                kernel_flash_train(torch, F, flush)
            entries += [rms_dx, dq_entry, dkv_entry, fwd_simt, dq_simt,
                        dkv_simt]
            entries += kernel_ce(torch, F, flush)
            entries[0]["train"] = rms_train
            entries[1]["train"] = attn_train
            entries += kernel_layernorm(torch, F, flush)
            for e, bert in zip((entries[1], dq_entry, dkv_entry),
                               kernel_flash_bert(torch, F, flush)):
                e["bert"] = bert
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        del flush
        torch.cuda.empty_cache()
        net, prompts = load_net(torch)
        counts, first_bf16 = serve(torch, F, net, prompts)
        torch.cuda.empty_cache()
        counts_q8 = serve_int8(torch, net, prompts, first_bf16)
        torch.cuda.empty_cache()
        counts_spec = serve_spec(torch, F, net)
        torch.cuda.empty_cache()
        serve_oracle(torch, F, net, prompts)
        torch.cuda.empty_cache()
        gen_counts = generate_phase(torch, net, prompts)
        del net
        torch.cuda.empty_cache()
        train_counts, fp32_counts = train_phase(torch, F, card)
        bert_counts = bert_phase(torch, F, card)
        transformer_phase(torch, F, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    decode_src = "mxnet_tpu_torch/csrc/decode_attention.cu"
    backward_src = "mxnet_tpu_torch/csrc/flash_backward.cu"
    fwd_tpu = "mxnet_tpu/kernels/flash_attention.py:188"
    dq_tpu = "mxnet_tpu/kernels/flash_attention.py:325"
    dkv_tpu = "mxnet_tpu/kernels/flash_attention.py:341"
    ce_src = "mxnet_tpu_torch/csrc/fused_ce.cu"
    ln_src = "mxnet_tpu_torch/csrc/layernorm.cu"
    # (symbol, source, TPU kernel's pallas_call, the main-path run whose
    # launch count the line reports)
    meta = {"rmsnorm": ("mxtt_rmsnorm", "mxnet_tpu_torch/csrc/rmsnorm.cu",
                        "mxnet_tpu/kernels/fused_norm.py:91", counts),
            "flash_fwd_tc": ("mxtt_flash_fwd_tc",
                             "mxnet_tpu_torch/csrc/flash_fwd_sm90.cu",
                             fwd_tpu, counts),
            "flash_prefill": ("mxtt_flash_prefill",
                              "mxnet_tpu_torch/csrc/flash_prefill.cu",
                              fwd_tpu, fp32_counts),
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
                                counts_q8),
            "paged_window": ("mxtt_paged_window",
                             "mxnet_tpu_torch/csrc/window_attention.cu",
                             "mxnet_tpu/kernels/flash_decode.py:613",
                             counts_spec),
            "rmsnorm_dx": ("mxtt_rmsnorm_dx",
                           "mxnet_tpu_torch/csrc/rmsnorm.cu",
                           "mxnet_tpu/kernels/fused_norm.py:114",
                           train_counts),
            "flash_bwd_dq_tc": ("mxtt_flash_bwd_dq_tc",
                                "mxnet_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
                                dq_tpu, train_counts),
            "flash_bwd_dq": ("mxtt_flash_bwd_dq", backward_src, dq_tpu,
                             fp32_counts),
            "flash_bwd_dkv_tc": ("mxtt_flash_bwd_dkv_tc",
                                 "mxnet_tpu_torch/csrc/flash_bwd_dkv_sm90.cu",
                                 dkv_tpu, train_counts),
            "flash_bwd_dkv": ("mxtt_flash_bwd_dkv", backward_src, dkv_tpu,
                              fp32_counts),
            "ce_fwd": ("mxtt_ce_fwd", ce_src,
                       "mxnet_tpu/kernels/fused_ce.py:119", train_counts),
            "ce_bwd": ("mxtt_ce_bwd", ce_src,
                       "mxnet_tpu/kernels/fused_ce.py:161", train_counts),
            "layernorm": ("mxtt_layernorm", ln_src,
                          "mxnet_tpu/kernels/fused_norm.py:207", bert_counts),
            "layernorm_dx": ("mxtt_layernorm_dx", ln_src,
                             "mxnet_tpu/kernels/fused_norm.py:234",
                             bert_counts)}
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
                        "library_ms": e["library_ms"], "shape": e["shape"],
                        **{key: e[key] for key in (
                            "verify", "train", "bert", "library",
                            "no_stats_ms", "simt_ms") if key in e}})
    print(card)                       # as nvidia-smi gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

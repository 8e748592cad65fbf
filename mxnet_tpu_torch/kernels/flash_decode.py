"""Decode attention over the port's four KV caches (`csrc/decode_attention.cu`,
one template) and window attention over the page pool: the CUDA kernels
and their plain PyTorch versions.

Counterpart of `mxnet_tpu/kernels/flash_decode.py`:

    flash_decode                  (B, K, S, d) cache, in q's dtype:
                                  _flash_decode_pallas
    flash_decode_quantized        int8 cache + fp32 scales:
                                  _flash_decode_pallas_q8
    flash_decode_paged            (N, K, bs, d) page pool:
                                  _flash_decode_paged_pallas
    flash_decode_paged_quantized  int8 pool + fp32 scales:
                                  _flash_decode_paged_pallas_q8
    flash_decode_paged_window     W window rows off the page pool:
                                  _flash_decode_paged_window_pallas

q (B, H, d) for one decode position, H = K * rep; valid_len (B,) int32
masks cache positions >= valid_len[b]; out (B, H, d) in q's dtype. Paged
caches are read through block_tables (B, nb) int32, physical block ids
in logical order, block 0 being the server's scratch block. An int8 cache
holds per-token symmetric codes with fp32 scales (B, K, S, 1) or
(N, K, bs, 1), made by `quantize_kv`. The contiguous kernels split each
row's walk over SPLIT-token ranges across blocks and merge the ranges'
partial softmaxes in a second launch of the same call, through an fp32
workspace the wrapper sizes from S alone.

Window attention (chunked prefill, speculative verify) takes q
(B, W, H, d) and valid_lens (B, W): each window row attends the cache
positions below its own length, so in-window causality needs no mask
and row w equals a single-position call at valid length valid_lens[:, w]
(flash_decode.py:480-490 of the JAX package). Two window kernels, the
route decided by the operands alone: bf16 at d in TC_HEAD_DIMS, H / K in
TC_REPS and block size in TC_BLOCK_SIZES takes the tensor-core kernel
(`csrc/window_attention_sm90.cu`: wgmma, the pool's pages staged by
TMA); anything else (float32, d = 16, another GQA factor or block size)
takes the SIMT kernel (`csrc/window_attention.cu`, d in HEAD_DIMS) or,
where neither takes it, raises. The int8 window,
`flash_decode_paged_window_quantized`, gathers and dequantizes like the
reference (which has no in-kernel int8 window) and is plain PyTorch on
every device.

A CPU tensor takes the plain version (differentiable, as the JAX
functions are); a CUDA tensor launches the kernel of its route (d in
HEAD_DIMS, or TC_HEAD_DIMS on the tensor-core window route; q float32 or
bfloat16; any S) or raises, also where autograd would need a gradient
through it: the decode and window kernels have no backward.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_decode", "flash_decode_quantized", "flash_decode_paged",
           "flash_decode_paged_quantized", "flash_decode_paged_window",
           "flash_decode_paged_window_quantized", "quantize_rows",
           "quantize_kv", "dequantize_kv", "gather_kv_pages",
           "reference_decode_attention", "reference_decode_quantized",
           "reference_paged_decode", "reference_paged_decode_quantized",
           "reference_window_attention", "reference_paged_window_attention"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: out, q, k, v, valid_len, workspace, B, H, K, d, S, scale, dtype, stream
_CONTIG = _build.CudaKernel("mxtt_contig_decode",
                            [_P] * 6 + [_I] * 5 + [_F, _I, _P])
#: out, q, k8, ks, v8, vs, valid_len, workspace, B, H, K, d, S, scale,
#: dtype, stream
_CONTIG_Q8 = _build.CudaKernel("mxtt_contig_decode_q8",
                               [_P] * 8 + [_I] * 5 + [_F, _I, _P])
#: out, q, k, v, block_tables, valid_len, B, H, K, d, bs, nb, scale,
#: dtype, stream
_PAGED = _build.CudaKernel("mxtt_paged_decode",
                           [_P] * 6 + [_I] * 6 + [_F, _I, _P])
#: out, q, k8, ks, v8, vs, block_tables, valid_len, B, H, K, d, bs, nb,
#: scale, dtype, stream
_PAGED_Q8 = _build.CudaKernel("mxtt_paged_decode_q8",
                              [_P] * 8 + [_I] * 6 + [_F, _I, _P])
#: out, q, k, v, block_tables, valid_lens, B, W, H, K, d, bs, nb, scale,
#: dtype, stream
_WINDOW = _build.CudaKernel("mxtt_paged_window",
                            [_P] * 6 + [_I] * 7 + [_F, _I, _P])

#: out, q, k, v, block_tables, valid_lens, B, W, H, K, d, bs, nb, N (the
#: pool's block count), scale, dtype, stream
_WINDOW_TC = _build.CudaKernel("mxtt_paged_window_tc",
                               [_P] * 6 + [_I] * 8 + [_F, _I, _P])

#: the head dims of the supported configs (llama_tiny, Llama-3-8B)
HEAD_DIMS = (16, 128)
#: what the tensor-core window kernel takes, in bf16: head dims, query
#: heads per kv head, page sizes
TC_HEAD_DIMS = (64, 128)
TC_REPS = (1, 2, 4, 8)
TC_BLOCK_SIZES = (8, 16, 32, 64)
#: the decode kernels' threads own rep * d <= 1024 outputs of one kv head
MAX_REP_DIM = 1024
#: tokens a block of the contiguous decode's split walk owns: the
#: workspace holds ceil(S / SPLIT) partials a (batch row, kv head). It
#: mirrors SPLIT in csrc/decode_attention.cu, which a test holds equal.
SPLIT = 64


# -- plain versions ----------------------------------------------------------

def quantize_rows(rows):
    """(..., d) rows -> (int8 codes (..., d), fp32 scales (..., 1)):
    symmetric abs-max over d, op for op as the JAX package's quantize_kv
    (amax in fp32, max(amax, 1e-8) / 127, divide, round half to even,
    clamp to 127), so the codes and scales are bit-identical."""
    rf = rows.float()
    scale = rf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(rf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_kv(k_cache, v_cache):
    """(B, K, S, d) caches -> int8 k, fp32 k scales (B, K, S, 1), int8
    v, v scales."""
    return quantize_rows(k_cache) + quantize_rows(v_cache)


def dequantize_kv(q8, scale, dtype=torch.bfloat16):
    return (q8.float() * scale).to(dtype)


def gather_kv_pages(pages, block_tables):
    """(N, K, bs, ...) pool + (B, nb) table -> (B, K, nb*bs, ...), the
    contiguous cache-native view. Stale rows in unallocated or scratch
    blocks are masked downstream by valid_len."""
    g = pages[block_tables.long()]                 # (B, nb, K, bs, ...)
    g = g.movedim(2, 1)                            # (B, K, nb, bs, ...)
    B, K, nb, bs = g.shape[:4]
    return g.reshape((B, K, nb * bs) + tuple(g.shape[4:]))


def reference_decode_attention(q, k_cache, v_cache, valid_len, scale=None):
    """Decode attention over (B, K, S, d) caches in fp32, GQA folded
    into the einsum (no repeat of the cache)."""
    B, H, d = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qr = q.reshape(B, K, rep, d).float()
    s = torch.einsum("bkrd,bksd->bkrs", qr, k_cache.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < valid_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bksd->bkrd", p, v_cache.float())
    return out.reshape(B, H, d).to(q.dtype)


def reference_decode_quantized(q, k8, ks, v8, vs, valid_len, scale=None):
    """The int8 kernels' plain version: dequantize to fp32, attend, cast
    to q's dtype (flash_decode.py:786-792 of the JAX package)."""
    return reference_decode_attention(
        q, dequantize_kv(k8, ks, torch.float32),
        dequantize_kv(v8, vs, torch.float32), valid_len, scale).to(q.dtype)


def reference_paged_decode(q, k_pages, v_pages, block_tables, valid_len,
                           scale=None):
    """The paged kernel's plain version: gather, then attend."""
    return reference_decode_attention(
        q, gather_kv_pages(k_pages, block_tables),
        gather_kv_pages(v_pages, block_tables), valid_len, scale)


def reference_paged_decode_quantized(q, k8_pages, ks_pages, v8_pages,
                                     vs_pages, block_tables, valid_len,
                                     scale=None):
    """The paged int8 kernel's plain version: gather codes and scales,
    then the int8 plain version."""
    g = [gather_kv_pages(p, block_tables)
         for p in (k8_pages, ks_pages, v8_pages, vs_pages)]
    return reference_decode_quantized(q, *g, valid_len, scale)


def reference_window_attention(q, k_cache, v_cache, valid_lens, scale=None):
    """Window attention over (B, K, S, d) caches in fp32: q (B, W, H, d),
    valid_lens (B, W) gives each window row its own length; the GQA
    einsum of reference_decode_attention with a window axis carried
    through (flash_decode.py:492-511 of the JAX package)."""
    B, W, H, d = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qr = q.reshape(B, W, K, rep, d).float()
    s = torch.einsum("bwkrd,bksd->bwkrs", qr, k_cache.float()) * scale
    mask = torch.arange(S, device=q.device)[None, None, :] \
        < valid_lens[:, :, None]
    s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bwkrs,bksd->bwkrd", p, v_cache.float())
    return out.reshape(B, W, H, d).to(q.dtype)


def reference_paged_window_attention(q, k_pages, v_pages, block_tables,
                                     valid_lens, scale=None):
    """The window kernel's plain version: gather, then the fp32 window
    reference."""
    return reference_window_attention(
        q, gather_kv_pages(k_pages, block_tables),
        gather_kv_pages(v_pages, block_tables), valid_lens, scale)


# -- kernel wrappers ---------------------------------------------------------

def _check(q, data, scales, valid_len, block_tables=None, window=False,
           head_dims=HEAD_DIMS):
    """Raise unless the operands are what the kernels take: q (B, H, d),
    or (B, W, H, d) with `window`, float32/bfloat16; data (two 4-D caches,
    in q's dtype or int8 when `scales` are given, 16-byte aligned) of one
    shape (B|N, K, S|bs, d); scales fp32 (..., 1) of the same leading
    shape; int32 valid_len (B,), or (B, W) with `window`, and
    block_tables (B, nb); d in `head_dims`. Returns (B, H, K, d, S|bs), or
    (B, W, H, K, d, bs) with `window`."""
    dev = q.device
    # the window kernel loads q rows 16 bytes at a time
    _build.check_cuda_tensor(q, "q", dev, ndim=4 if window else 3,
                             align16=window)
    cache_dtypes = (torch.int8,) if scales else (q.dtype,)
    for name, t in zip(("k", "v"), data):
        _build.check_cuda_tensor(t, name, dev, dtypes=cache_dtypes, ndim=4,
                                 align16=True)
    lead = tuple(q.shape[:-2])                     # (B,) or (B, W)
    B, H, d = q.shape[0], q.shape[-2], q.shape[-1]
    N, K, S, dk = data[0].shape
    if data[1].shape != data[0].shape or dk != d or H % K:
        raise ValueError(f"q {tuple(q.shape)}, caches "
                         f"{tuple(data[0].shape)}/{tuple(data[1].shape)}: "
                         "expected (·, H, d) and (·, K, ·, d), H % K == 0")
    for name, t in zip(("ks", "vs"), scales):
        _build.check_cuda_tensor(t, name, dev, dtypes=(torch.float32,),
                                 ndim=4)
        if t.shape != (N, K, S, 1):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                             f"{(N, K, S, 1)}")
    _build.check_cuda_tensor(valid_len, "valid_len", dev,
                             dtypes=(torch.int32,), ndim=len(lead))
    if tuple(valid_len.shape) != lead:
        raise ValueError(f"valid_len has shape {tuple(valid_len.shape)}; "
                         f"expected {lead}")
    rows = [valid_len]
    if block_tables is None:
        if N != B:
            raise ValueError(f"cache batch {N} != q batch {B}")
    else:
        _build.check_cuda_tensor(block_tables, "block_tables", dev,
                                 dtypes=(torch.int32,), ndim=2)
        rows.append(block_tables)
    if any(t.shape[0] != B for t in rows):
        raise ValueError("valid_len and block_tables need one row per "
                         "batch row")
    if d not in head_dims or (not window and (H // K) * d > MAX_REP_DIM):
        raise ValueError(f"head dim {d} (in {head_dims}) with {H // K} "
                         f"query heads per kv head exceeds the kernel")
    return lead + (H, K, d, S)


def _window_tensor_cores(q, k_pages):
    """Whether a window call goes to the tensor-core kernel: bf16, and a
    head dim, GQA factor and page size it takes (shapes checked)."""
    H, d = q.shape[-2], q.shape[-1]
    K, bs = k_pages.shape[1], k_pages.shape[2]
    return q.dtype == torch.bfloat16 and d in TC_HEAD_DIMS \
        and H // K in TC_REPS and bs in TC_BLOCK_SIZES


def _launch(kernel, q, operands, sizes, scale):
    """Allocate the output and launch on q's device and current stream;
    `operands` are the tensors after out and q, in the C order. The
    kernels have no backward: a gradient through one raises."""
    _build.check_no_grad(kernel.symbol, q, *operands)
    out = torch.empty_like(q)
    _build.launch(kernel, q.device, out.data_ptr(), q.data_ptr(),
                  *(t.data_ptr() for t in operands), *sizes, float(scale),
                  _build.dtype_code(q))
    return out


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _split_workspace(q, K, S):
    """The contiguous kernels' fp32 partials (B, K, ceil(S / SPLIT), rep,
    d + 2): acc, the running max and sum of each token range. Sized from
    S alone: reading valid_len here would synchronise the host with the
    card once a layer."""
    B, H, d = q.shape
    return torch.empty((B, K, -(-S // SPLIT), H // K, d + 2),
                       dtype=torch.float32, device=q.device)


def flash_decode(q, k_cache, v_cache, valid_len, scale=None):
    """Decode attention over contiguous (B, K, S, d) caches."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k_cache, v_cache, valid_len,
                                          scale)
    sizes = _check(q, (k_cache, v_cache), (), valid_len)
    ws = _split_workspace(q, sizes[2], sizes[4])
    return _launch(_CONTIG, q, (k_cache, v_cache, valid_len, ws), sizes,
                   scale)


def flash_decode_quantized(q, k8, ks, v8, vs, valid_len, scale=None):
    """Decode attention over a contiguous int8 cache with per-token fp32
    scales (see quantize_kv)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_decode_quantized(q, k8, ks, v8, vs, valid_len,
                                          scale)
    sizes = _check(q, (k8, v8), (ks, vs), valid_len)
    ws = _split_workspace(q, sizes[2], sizes[4])
    return _launch(_CONTIG_Q8, q, (k8, ks, v8, vs, valid_len, ws), sizes,
                   scale)


def flash_decode_paged(q, k_pages, v_pages, block_tables, valid_len,
                       scale=None):
    """Block-table decode attention straight off the page pool."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_paged_decode(q, k_pages, v_pages, block_tables,
                                      valid_len, scale)
    sizes = _check(q, (k_pages, v_pages), (), valid_len, block_tables)
    return _launch(_PAGED, q, (k_pages, v_pages, block_tables, valid_len),
                   sizes + (block_tables.shape[1],), scale)


def flash_decode_paged_quantized(q, k8_pages, ks_pages, v8_pages, vs_pages,
                                 block_tables, valid_len, scale=None):
    """Block-table decode attention straight off the int8 page pool."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_paged_decode_quantized(
            q, k8_pages, ks_pages, v8_pages, vs_pages, block_tables,
            valid_len, scale)
    sizes = _check(q, (k8_pages, v8_pages), (ks_pages, vs_pages), valid_len,
                   block_tables)
    return _launch(_PAGED_Q8, q, (k8_pages, ks_pages, v8_pages, vs_pages,
                                  block_tables, valid_len),
                   sizes + (block_tables.shape[1],), scale)


def flash_decode_paged_window(q, k_pages, v_pages, block_tables, valid_lens,
                              scale=None):
    """W-position window attention straight off the page pool (chunked
    prefill, speculative verify): q (B, W, H, d), valid_lens (B, W)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_paged_window_attention(
            q, k_pages, v_pages, block_tables, valid_lens, scale)
    sizes = _check(q, (k_pages, v_pages), (), valid_lens, block_tables,
                   window=True, head_dims=HEAD_DIMS + TC_HEAD_DIMS)
    operands = (k_pages, v_pages, block_tables, valid_lens)
    nb = block_tables.shape[1]
    if _window_tensor_cores(q, k_pages):
        N, K, bs = k_pages.shape[:3]
        if N * K * bs >= 2 ** 31:
            raise ValueError(f"a pool of {N} x {K} x {bs} rows exceeds the "
                             f"tensor-core kernel's 2^31")
        return _launch(_WINDOW_TC, q, operands, sizes + (nb, N), scale)
    if sizes[4] not in HEAD_DIMS:
        raise ValueError(f"head dim {sizes[4]} takes the tensor-core window "
                         f"kernel only (bf16, H/K in {TC_REPS}, block size in "
                         f"{TC_BLOCK_SIZES}); the SIMT kernel takes "
                         f"{HEAD_DIMS}")
    return _launch(_WINDOW, q, operands, sizes + (nb,), scale)


def flash_decode_paged_window_quantized(q, k8_pages, ks_pages, v8_pages,
                                        vs_pages, block_tables, valid_lens,
                                        scale=None):
    """Window attention against the int8 pool, on every device as the
    reference does it (flash_decode.py:649-666 of the JAX package): gather
    codes and scales, dequantize to fp32, the window reference, cast to
    q's dtype."""
    g = [gather_kv_pages(p, block_tables)
         for p in (k8_pages, ks_pages, v8_pages, vs_pages)]
    return reference_window_attention(
        q, dequantize_kv(g[0], g[1], torch.float32),
        dequantize_kv(g[2], g[3], torch.float32), valid_lens, _scale(q, scale))

"""Single-position decode attention over the port's four KV caches: the
CUDA kernels (`csrc/decode_attention.cu`, one template) and their plain
PyTorch versions.

Counterpart of `mxnet_tpu/kernels/flash_decode.py`:

    flash_decode                  (B, K, S, d) cache, in q's dtype:
                                  _flash_decode_pallas
    flash_decode_quantized        int8 cache + fp32 scales:
                                  _flash_decode_pallas_q8
    flash_decode_paged            (N, K, bs, d) page pool:
                                  _flash_decode_paged_pallas
    flash_decode_paged_quantized  int8 pool + fp32 scales:
                                  _flash_decode_paged_pallas_q8

q (B, H, d) for one decode position, H = K * rep; valid_len (B,) int32
masks cache positions >= valid_len[b]; out (B, H, d) in q's dtype. Paged
caches are read through block_tables (B, nb) int32, physical block ids
in logical order, block 0 being the server's scratch block. An int8 cache
holds per-token symmetric codes with fp32 scales (B, K, S, 1) or
(N, K, bs, 1), made by `quantize_kv`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(d in HEAD_DIMS, q float32 or bfloat16, any S) or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_decode", "flash_decode_quantized", "flash_decode_paged",
           "flash_decode_paged_quantized", "quantize_rows", "quantize_kv",
           "dequantize_kv", "gather_kv_pages", "reference_decode_attention",
           "reference_decode_quantized", "reference_paged_decode",
           "reference_paged_decode_quantized"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: out, q, k, v, valid_len, B, H, K, d, S, scale, dtype, stream
_CONTIG = _build.CudaKernel("mxtt_contig_decode",
                            [_P] * 5 + [_I] * 5 + [_F, _I, _P])
#: out, q, k8, ks, v8, vs, valid_len, B, H, K, d, S, scale, dtype, stream
_CONTIG_Q8 = _build.CudaKernel("mxtt_contig_decode_q8",
                               [_P] * 7 + [_I] * 5 + [_F, _I, _P])
#: out, q, k, v, block_tables, valid_len, B, H, K, d, bs, nb, scale,
#: dtype, stream
_PAGED = _build.CudaKernel("mxtt_paged_decode",
                           [_P] * 6 + [_I] * 6 + [_F, _I, _P])
#: out, q, k8, ks, v8, vs, block_tables, valid_len, B, H, K, d, bs, nb,
#: scale, dtype, stream
_PAGED_Q8 = _build.CudaKernel("mxtt_paged_decode_q8",
                              [_P] * 8 + [_I] * 6 + [_F, _I, _P])

#: the head dims of the supported configs (llama_tiny, Llama-3-8B)
HEAD_DIMS = (16, 128)
#: the kernel's threads own rep * d <= 1024 outputs of one kv head
MAX_REP_DIM = 1024


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


# -- kernel wrappers ---------------------------------------------------------

def _check(q, data, scales, valid_len, block_tables=None):
    """Raise unless the operands are what the kernels take: q (B, H, d)
    float32/bfloat16; data (two 4-D caches, in q's dtype or int8 when
    `scales` are given, 16-byte aligned) of one shape (B|N, K, S|bs, d);
    scales fp32 (..., 1) of the same leading shape; int32 valid_len (B,)
    and block_tables (B, nb). Returns (B, H, K, d, S|bs)."""
    dev = q.device
    _build.check_cuda_tensor(q, "q", dev, ndim=3)
    cache_dtypes = (torch.int8,) if scales else (q.dtype,)
    for name, t in zip(("k", "v"), data):
        _build.check_cuda_tensor(t, name, dev, dtypes=cache_dtypes, ndim=4,
                                 align16=True)
    B, H, d = q.shape
    N, K, S, dk = data[0].shape
    if data[1].shape != data[0].shape or dk != d or H % K:
        raise ValueError(f"q {tuple(q.shape)}, caches "
                         f"{tuple(data[0].shape)}/{tuple(data[1].shape)}: "
                         "expected (B, H, d) and (·, K, ·, d), H % K == 0")
    for name, t in zip(("ks", "vs"), scales):
        _build.check_cuda_tensor(t, name, dev, dtypes=(torch.float32,),
                                 ndim=4)
        if t.shape != (N, K, S, 1):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected "
                             f"{(N, K, S, 1)}")
    _build.check_cuda_tensor(valid_len, "valid_len", dev,
                             dtypes=(torch.int32,), ndim=1)
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
    if d not in HEAD_DIMS or (H // K) * d > MAX_REP_DIM:
        raise ValueError(f"head dim {d} (in {HEAD_DIMS}) with {H // K} "
                         f"query heads per kv head exceeds the kernel")
    return B, H, K, d, S


def _launch(kernel, q, operands, sizes, scale):
    """Allocate the output and launch on q's device and current stream;
    `operands` are the tensors after out and q, in the C order."""
    out = torch.empty_like(q)
    dev = q.device
    with torch.cuda.device(dev):
        kernel(out.data_ptr(), q.data_ptr(),
               *(t.data_ptr() for t in operands), *sizes, float(scale),
               _build.dtype_code(q), _build.stream_handle(dev))
    return out


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_decode(q, k_cache, v_cache, valid_len, scale=None):
    """Decode attention over contiguous (B, K, S, d) caches."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_decode_attention(q, k_cache, v_cache, valid_len,
                                          scale)
    sizes = _check(q, (k_cache, v_cache), (), valid_len)
    return _launch(_CONTIG, q, (k_cache, v_cache, valid_len), sizes, scale)


def flash_decode_quantized(q, k8, ks, v8, vs, valid_len, scale=None):
    """Decode attention over a contiguous int8 cache with per-token fp32
    scales (see quantize_kv)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return reference_decode_quantized(q, k8, ks, v8, vs, valid_len,
                                          scale)
    sizes = _check(q, (k8, v8), (ks, vs), valid_len)
    return _launch(_CONTIG_Q8, q, (k8, ks, v8, vs, valid_len), sizes, scale)


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

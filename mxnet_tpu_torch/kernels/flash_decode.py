"""Paged single-token decode attention: the CUDA kernel
(`csrc/paged_decode.cu`) and its plain PyTorch version.

Counterpart of `mxnet_tpu/kernels/flash_decode.py`
(`flash_decode_paged`, the `_flash_decode_paged_pallas` kernel). q
(B, H, d) for one decode position; k/v pages (N, K, bs, d), block 0
being the server's scratch block; block_tables (B, nb) int32 physical
ids in logical order; valid_len (B,) int32. A CPU tensor takes the plain
version (gather the contiguous view, then `reference_decode_attention`);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_decode_paged", "gather_kv_pages",
           "reference_decode_attention", "reference_paged_decode"]

_KERNEL = _build.CudaKernel("mxtt_paged_decode", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p])

#: the head dims of the supported configs (llama_tiny, Llama-3-8B)
HEAD_DIMS = (16, 128)
#: the kernel's threads own rep * d <= 1024 outputs of one kv head
MAX_REP_DIM = 1024


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


def reference_paged_decode(q, k_pages, v_pages, block_tables, valid_len,
                           scale=None):
    """The plain version of the kernel: gather, then attend."""
    return reference_decode_attention(
        q, gather_kv_pages(k_pages, block_tables),
        gather_kv_pages(v_pages, block_tables), valid_len, scale)


def flash_decode_paged(q, k_pages, v_pages, block_tables, valid_len,
                       scale=None):
    """Block-table decode attention straight off the page pool."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return reference_paged_decode(q, k_pages, v_pages, block_tables,
                                      valid_len, scale)
    dev = q.device
    _build.check_cuda_tensor(q, "q", dev, ndim=3)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _build.check_cuda_tensor(t, name, dev, dtypes=(q.dtype,), ndim=4,
                                 align16=True)
    for name, t, nd in (("block_tables", block_tables, 2),
                        ("valid_len", valid_len, 1)):
        _build.check_cuda_tensor(t, name, dev, dtypes=(torch.int32,),
                                 ndim=nd)
    B, H, d = q.shape
    N, K, bs, dk = k_pages.shape
    nb = block_tables.shape[1]
    if v_pages.shape != k_pages.shape or dk != d or H % K:
        raise ValueError(f"q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}: "
                         "expected (B, H, d) and (N, K, bs, d), H % K == 0")
    if block_tables.shape[0] != B or valid_len.shape[0] != B:
        raise ValueError("block_tables and valid_len need one row per "
                         "batch row")
    if d not in HEAD_DIMS or (H // K) * d > MAX_REP_DIM:
        raise ValueError(f"head dim {d} (in {HEAD_DIMS}) with {H // K} "
                         f"query heads per kv head exceeds the kernel")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        _KERNEL(out.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), block_tables.data_ptr(),
                valid_len.data_ptr(), B, H, K, d, bs, nb, float(scale),
                _build.dtype_code(q), _build.stream_handle(dev))
    return out

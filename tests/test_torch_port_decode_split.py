"""The contiguous decode kernels' split walk, rehearsed on the CPU.

`mxtt_contig_decode` and `mxtt_contig_decode_q8`
(`csrc/decode_attention.cu`) split each (batch row, kv head)'s walk over
ranges of SPLIT tokens, one block a range, and merge the ranges' partial
softmaxes in a second kernel. Here their arithmetic is emulated in fp32
on inputs from a numpy seed: per range, the online softmax over 64-token
tiles (the k scale on the score, the v scale on p before P V, the
running sum of the unscaled p); no partial for a range at or past
valid_len (clamped to the cache); the merge in ascending range order,
M = max m, out = sum exp(m - M) acc / sum exp(m - M) l; one rounding of
the output, zeros where no key is valid.

The emulation must lie within `chip_smoke.py`'s decode tolerance (the
one the card holds the kernels to) of the plain version and of the JAX
Pallas kernels in interpret mode on the same inputs, a row with no valid
key must come out zero, and attention with valid_len off by one must lie
outside the tolerance.
"""
import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import flash_decode as jfd

import chip_smoke as cs
from mxnet_tpu_torch.kernels import flash_decode as fd

SOURCE = (Path(__file__).resolve().parent.parent / "mxnet_tpu_torch"
          / "csrc" / "decode_attention.cu").read_text()
#: the split walk's tokens a block, as the kernels' source sets them
SPLIT = int(re.search(r"constexpr int SPLIT = (\d+);", SOURCE).group(1))
TT = 64                          # tokens a tile
H, K = 8, 2


def _lengths(S):
    """0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S and S + 5 (clamped to S)."""
    return np.asarray([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S, S + 5],
                      np.int32)


def _inputs(kind, S, seed):
    """q (B, H, d), the caches as the kernel takes them, and the caches
    dequantized to fp32 (for the tolerance and the off-by-one rows)."""
    rs = np.random.RandomState(seed)
    vl = _lengths(S)
    B = len(vl)
    d = 16 if kind == "fp32" else 128
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16

    def rows(*shape, spread=0.0):
        mag = np.exp(spread * rs.randn(*shape[:-1], 1))
        return torch.from_numpy((rs.randn(*shape) * mag).astype(np.float32)) \
            .to(dtype)
    q = rows(B, H, d)
    k, v = rows(B, K, S, d, spread=0.5), rows(B, K, S, d, spread=1.5)
    if kind == "int8":
        cache = fd.quantize_kv(k, v)
        deq = (fd.dequantize_kv(cache[0], cache[1], torch.float32),
               fd.dequantize_kv(cache[2], cache[3], torch.float32))
    else:
        cache = deq = (k, v)
    return q, cache, deq, torch.from_numpy(vl)


def emulate_split(q, cache, valid_len, scale):
    """out (B, H, d) in q's dtype as the split walk and the merge compute
    it, in fp32. `cache` is (k, v) or, for int8, (k8, ks, v8, vs)."""
    q8 = len(cache) == 4
    k, v = (cache[0], cache[2]) if q8 else cache
    B, Hq, d = q.shape
    Kq, S = k.shape[1], k.shape[2]
    rep = Hq // Kq
    ns = -(-S // SPLIT)
    out = torch.zeros(B, Hq, d)
    for b in range(B):
        vl = max(0, min(int(valid_len[b]), S))
        for kh in range(Kq):
            qr = q[b, kh * rep:(kh + 1) * rep].float() * scale
            parts = []                        # (acc, m, l) of each range
            for split in range(ns):
                lo = split * SPLIT
                if lo >= vl:                  # the block writes nothing
                    break
                hi = min(lo + SPLIT, vl)
                m = torch.full((rep,), -math.inf)
                l = torch.zeros(rep)
                acc = torch.zeros(rep, d)
                for t0 in range(lo, hi, TT):
                    t1 = min(t0 + TT, S)
                    s = qr @ k[b, kh, t0:t1].float().T
                    if q8:                    # s = (q . k8) * ks
                        s = s * cache[1][b, kh, t0:t1, 0]
                    key = t0 + torch.arange(t1 - t0)
                    s = s.masked_fill(key[None, :] >= hi, -math.inf)
                    mx = torch.maximum(m, s.amax(dim=-1))
                    p = torch.where(mx[:, None] > -math.inf,
                                    torch.exp(s - mx[:, None]), 0.0)
                    corr = torch.where(m > -math.inf, torch.exp(m - mx), 0.0)
                    l = corr * l + p.sum(dim=-1)  # l adds the unscaled p
                    if q8:                    # P V takes p * vs
                        p = p * cache[3][b, kh, t0:t1, 0]
                    acc = corr[:, None] * acc + p @ v[b, kh, t0:t1].float()
                    m = mx
                parts.append((acc, m, l))
            num, den = torch.zeros(rep, d), torch.zeros(rep)
            if parts:
                M = torch.stack([m for _, m, _ in parts]).amax(dim=0)
                for acc, m, l in parts:       # ascending ranges
                    w = torch.where(m > -math.inf, torch.exp(m - M), 0.0)
                    num = num + w[:, None] * acc
                    den = den + w * l
            res = torch.where(den[:, None] > 0,
                              num / torch.where(den > 0, den, 1.0)[:, None],
                              0.0)
            out[b, kh * rep:(kh + 1) * rep] = res
    return out.to(q.dtype)


def _pallas(kind, q, cache, vl, scale):
    """The JAX Pallas kernel of the cache kind in interpret mode, as a
    float32 tensor."""
    def j(t):
        a = jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16
                        else t.numpy())
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a
    fn = jfd._flash_decode_pallas_q8 if kind == "int8" \
        else jfd._flash_decode_pallas
    out = fn(j(q), *map(j, cache), jnp.asarray(vl.numpy()), scale,
             interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("S", [77, 333, 544])
@pytest.mark.parametrize("kind", ["bf16", "int8", "fp32"])
def test_split_walk_within_the_card_tolerance(kind, S):
    q, cache, (kd, vd), vl = _inputs(kind, S, 11 * S + len(kind))
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    plain = fd.reference_decode_quantized if kind == "int8" \
        else fd.reference_decode_attention
    # the plain version's softmax over no key is NaN, as the JAX
    # reference's; the kernels write zeros, as the Pallas kernels do
    ref = torch.where((vl > 0)[:, None, None], plain(q, *cache, vl, scale),
                      0)
    tol = cs.decode_tol(torch, q, kd, vd, vl, ref, scale)
    got = emulate_split(q, cache, vl, scale)
    assert got.dtype == q.dtype and tol.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    assert bool((got[0] == 0).all()), "the valid_len = 0 row is not zero"
    pallas = _pallas(kind, q, cache, vl, scale)
    for name, theirs in (("plain", ref.float()), ("pallas", pallas)):
        over = int(((got.float() - theirs).abs() > tol).sum())
        assert over == 0, f"{over} elements beyond the tolerance of {name}"
    for dv in (1, -1):
        wrong = cs.cached_attention(torch, q[:, None], kd, vd,
                                    (vl + dv)[:, None], scale)[0][:, 0] \
            .to(q.dtype)
        over = int(((wrong.float() - ref.float()).abs() > tol).sum())
        assert over > 0, f"valid_len{dv:+d} passes the tolerance"


def test_split_is_whole_tiles_and_the_wrapper_mirrors_it():
    """The wrapper sizes the workspace with its own SPLIT, which must be
    the kernels': with a larger one they would write past its end."""
    assert SPLIT in (64, 128, 256) and SPLIT % TT == 0
    assert fd.SPLIT == SPLIT


C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", ["_CONTIG", "_CONTIG_Q8"])
def test_contiguous_argtypes_match_the_c_signature(kernel):
    """The wrapper's ctypes argtypes follow the entry point's parameters
    one for one (every pointer, the workspace among them, a c_void_p)."""
    k = getattr(fd, kernel)
    params = re.search(r'extern "C" int ' + k.symbol + r"\(([^)]*)\)",
                       SOURCE).group(1)
    want = []
    for p in params.split(","):
        p = " ".join(p.replace("const ", "").split())
        want.append(C_TYPES["void*" if "*" in p else p.split()[0]])
    assert k.argtypes == want

"""The tensor-core window kernel's roundings, rehearsed on the CPU.

The bf16 route of the paged window attention
(`csrc/window_attention_sm90.cu`) feeds wgmma with P rounded to bf16,
where the SIMT kernel (`csrc/window_attention.cu`) and the JAX Pallas
kernel keep it in fp32. Here its arithmetic is emulated in fp32 on
bf16-valued inputs from a numpy seed: per kv head, blocks of the
kernel's CONSUMERS x 64 folded rows, each consumer's 64 head-major (rep
query heads x 64/rep window positions); 64-key tiles assembled page by
page through a shuffled block table, page slots past the block's last
valid page re-loading it; a consumer skipping the tiles past its longest
row; the online softmax with exp2 against the running max; P rounded to
bf16 before P V; the row sum of the unrounded P; one rounding of the
output.

The emulation must lie within `chip_smoke.py`'s window tolerance (the
one the card holds the kernel to) of the plain version and of the JAX
Pallas window kernel in interpret mode on the same inputs, and attention
with valid_lens off by one must lie outside it.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels import flash_decode as jfd

import chip_smoke as cs
from mxnet_tpu_torch.kernels.flash_decode import (
    gather_kv_pages, reference_paged_window_attention)

B, H, K = 2, 8, 2
BN = 64                          # keys a tile
LOG2E = math.log2(math.e)
#: the kernel's consumer warpgroups a block, as its source sets them
CONSUMERS = int(re.search(
    r"constexpr int CONSUMERS = (\d+);",
    (Path(__file__).resolve().parent.parent / "mxnet_tpu_torch" / "csrc"
     / "window_attention_sm90.cu").read_text()).group(1))


def _inputs(W, d, bs, seed):
    """q (B, W, H, d) and pools (N, K, bs, d), bf16-valued; block tables
    with shuffled physical ids (entries past each row's longest window at
    scratch block 0); valid lengths: row 0 from position 0 (1..W), row 1
    a verify tick after a short draft ([300, 301, 1, 1, ...])."""
    rs = np.random.RandomState(seed)
    nb = 320 // bs
    N = B * nb + 1

    def bf16(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)) \
            .to(torch.bfloat16)
    q, kp, vp = bf16(B, W, H, d), bf16(N, K, bs, d), bf16(N, K, bs, d)
    vls = np.ones((B, W), np.int32)
    vls[0] = np.arange(1, W + 1)
    vls[1, :2] = (300, 301)
    ids = 1 + rs.permutation(N - 1)
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        n = -(-int(vls[b].max()) // bs)
        bt[b, :n] = ids[b * nb:b * nb + n]
    return q, kp, vp, torch.from_numpy(bt), torch.from_numpy(vls)


def emulate_window_tc(q, k_pages, v_pages, block_tables, valid_lens, scale):
    """out (B, W, H, d) in q's dtype as the tensor-core window kernel
    computes it, in fp32."""
    Bq, W, Hq, d = q.shape
    Kq, bs = k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    rep = Hq // Kq
    P = 64 // rep                            # window positions a consumer
    c2 = scale * LOG2E
    out = torch.zeros(Bq, W, Hq, d)
    for b in range(Bq):
        lens = valid_lens[b].long().clamp(0, nb * bs)
        for kh in range(Kq):
            for wb in range(0, W, CONSUMERS * P):          # one block
                # each consumer's rows r: head r // P at position w0 + r % P
                rows = []
                for w0 in range(wb, wb + CONSUMERS * P, P):
                    w = w0 + torch.arange(64) % P
                    head = kh * rep + torch.arange(64) // P
                    ln = torch.where(w < W, lens[w.clamp(max=W - 1)], 0)
                    rows.append((w, head, ln))
                kend = max(int(ln.max()) for _, _, ln in rows)
                last = -(-kend // bs) - 1            # last page read
                for w, head, ln in rows:
                    live = w < W
                    qr = torch.zeros(64, d)
                    qr[live] = q[b, w[live], head[live]].float()
                    m = torch.full((64,), -math.inf)
                    l = torch.zeros(64)
                    o = torch.zeros(64, d)
                    for k0 in range(0, int(ln.max()), BN):
                        # the tile, page by page through the table
                        pages = [int(block_tables[b, min(k0 // bs + j,
                                                         last)])
                                 for j in range(BN // bs)]
                        kt = torch.cat([k_pages[p, kh] for p in pages])
                        vt = torch.cat([v_pages[p, kh] for p in pages])
                        s = qr @ kt.float().T
                        key = k0 + torch.arange(BN)
                        s = s.masked_fill(key[None, :] >= ln[:, None],
                                          -math.inf)
                        mx = torch.maximum(m, s.amax(dim=-1))
                        base = torch.where(mx == -math.inf, 0.0, mx * c2)
                        corr = torch.where(mx == m, 1.0,
                                           torch.exp2(m * c2 - base))
                        p = torch.exp2(s * c2 - base[:, None])
                        l = l * corr + p.sum(dim=-1)
                        o = o * corr[:, None] \
                            + p.to(torch.bfloat16).float() @ vt.float()
                        m = mx
                    res = torch.where(l[:, None] > 0, o / l[:, None], 0.0)
                    out[b, w[live], head[live]] = res[live]
    return out.to(q.dtype)


@pytest.mark.parametrize("W", [5, 40])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("d", [64, 128])
def test_window_rounding_within_the_card_tolerance(d, bs, W):
    q, kp, vp, bt, vls = _inputs(W, d, bs, 7 * d + bs + W)
    scale = 1.0 / math.sqrt(d)
    ref = reference_paged_window_attention(q, kp, vp, bt, vls, scale)
    kc, vc = gather_kv_pages(kp, bt), gather_kv_pages(vp, bt)
    tol = cs.window_tol(torch, q, kc, vc, vls, ref, scale)
    got = emulate_window_tc(q, kp, vp, bt, vls, scale)
    bf = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, kp, vp)]
    pallas = jfd._flash_decode_paged_window_pallas(
        *bf, jnp.asarray(bt.numpy()), jnp.asarray(vls.numpy()), scale,
        interpret=True)
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    assert tol.shape == ref.shape
    for name, theirs in (("plain", ref.float()), ("pallas", pallas)):
        over = int(((got.float() - theirs).abs() > tol).sum())
        assert over == 0, f"{over} elements beyond the tolerance of {name}"
    # the emulation rounds P: it is not the plain version over again
    assert not torch.equal(got, ref)
    for dv in (1, -1):
        wrong = cs.cached_attention(torch, q, kc, vc, vls + dv,
                                    scale)[0].to(q.dtype)
        over = int(((wrong.float() - ref.float()).abs() > tol).sum())
        assert over > 0, f"valid_lens{dv:+d} passes the tolerance"

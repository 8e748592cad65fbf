"""The port's kernel modules on the CPU: each plain PyTorch version (what a
kernel wrapper runs for a CPU tensor) against the JAX package's Pallas
kernel in interpret mode and against its jnp reference, on the same
inputs made with numpy. fp32 throughout; tolerances are fp32 sum-order
differences (about 1e-6 relative) with headroom. The CUDA kernels
themselves are held against these plain versions on the card by
`chip_smoke.py`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.kernels.flash_attention import (
    _pallas_forward, reference_attention as jax_reference_attention)
from mxnet_tpu.kernels.flash_decode import (
    _flash_decode_paged_pallas, gather_kv_pages as jax_gather_kv_pages,
    reference_decode_attention as jax_reference_decode)
from mxnet_tpu.kernels.fused_norm import _rms_pallas_fwd, fused_rmsnorm

from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (
    flash_attention_forward, reference_attention)
from mxnet_tpu_torch.kernels.flash_decode import (
    flash_decode, flash_decode_paged, flash_decode_paged_quantized,
    flash_decode_quantized, gather_kv_pages, quantize_kv,
    reference_decode_attention)
from mxnet_tpu_torch.kernels.fused_norm import rmsnorm, rmsnorm_ref

T_ = torch.from_numpy


# -- RMSNorm ------------------------------------------------------------------

@pytest.mark.parametrize("rows,dim", [(8, 64), (37, 64), (5, 256)])
def test_rmsnorm_matches_pallas_interpret_and_jnp(rows, dim):
    rs = np.random.RandomState(rows + dim)
    x = rs.randn(rows, dim).astype(np.float32) * 3
    g = (1 + 0.1 * rs.randn(dim)).astype(np.float32)
    eps = 1e-5
    pallas, _ = _rms_pallas_fwd(jnp.asarray(x), jnp.asarray(g), eps,
                                interpret=True)
    jnp_out = fused_rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=eps)
    ours = rmsnorm(T_(x), T_(g), eps)
    np.testing.assert_allclose(rmsnorm_ref(T_(x), T_(g), eps).numpy(),
                               ours.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jnp_out),
                               rtol=1e-5, atol=1e-5)


def test_rmsnorm_keeps_bf16_and_fp32_gain():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(3, 5, 64).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rs.randn(64)).astype(np.float32))
    xb = x.bfloat16()
    out = rmsnorm(xb, g, 1e-5)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    # fp32 statistics and math, one rounding to bf16 at the end
    np.testing.assert_array_equal(
        out.float().numpy(),
        rmsnorm(xb.float(), g, 1e-5).bfloat16().float().numpy())


# -- flash prefill ------------------------------------------------------------

@pytest.mark.parametrize("lengths", [[128, 128], [128, 77], [50, 0]])
def test_flash_prefill_plain_matches_pallas_interpret(lengths):
    rs = np.random.RandomState(sum(lengths))
    B, T, H, K, d = 2, 128, 4, 2, 16
    q = rs.randn(B, T, H, d).astype(np.float32)
    k = rs.randn(B, T, K, d).astype(np.float32)
    v = rs.randn(B, T, K, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / np.sqrt(d)
    pallas = _pallas_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, scale=scale, block_q=64,
                             block_k=64, interpret=True,
                             lengths=jnp.asarray(lens))
    jref = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True, scale,
                                   jnp.asarray(lens))
    ours = flash_attention_forward(T_(q), T_(k), T_(v), True, scale,
                                   T_(lens))
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jref),
                               rtol=1e-5, atol=2e-5)
    if lengths[1] == 0:          # no valid key: exact zeros
        assert not ours[1].any()


def test_flash_prefill_plain_ragged_t_and_non_causal():
    """T not a multiple of 128 (where the JAX package never launches its
    kernel) against the jnp reference, causal and not."""
    rs = np.random.RandomState(7)
    B, T, H, K, d = 2, 45, 4, 1, 32
    q, k, v = (rs.randn(B, T, n, d).astype(np.float32)
               for n in (H, K, K))
    lens = np.asarray([45, 17], np.int32)
    for causal in (True, False):
        jref = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, 0.3,
                                       jnp.asarray(lens))
        ours = reference_attention(T_(q), T_(k), T_(v), causal, 0.3,
                                   T_(lens))
        np.testing.assert_allclose(ours.numpy(), np.asarray(jref),
                                   rtol=1e-5, atol=2e-5)


# -- paged decode -------------------------------------------------------------

def _paged_inputs(rs, B, H, K, d, bs, nb, vls):
    N = B * nb + 1
    q = rs.randn(B, H, d).astype(np.float32)
    kp = rs.randn(N, K, bs, d).astype(np.float32)
    vp = rs.randn(N, K, bs, d).astype(np.float32)
    ids = 1 + rs.permutation(N - 1)
    bt = np.zeros((B, nb), np.int32)       # past valid_len: scratch 0
    for b, vl in enumerate(vls):
        n = -(-vl // bs)
        bt[b, :n] = ids[b * nb:b * nb + n]
    return q, kp, vp, bt, np.asarray(vls, np.int32)


@pytest.mark.parametrize("bs,vls", [(8, [1, 13, 32]), (16, [16, 33, 5])])
def test_paged_decode_plain_matches_pallas_interpret(bs, vls):
    rs = np.random.RandomState(bs)
    q, kp, vp, bt, vl = _paged_inputs(rs, 3, 4, 2, 16, bs, 64 // bs, vls)
    pallas = _flash_decode_paged_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(vl), 0.25, interpret=True)
    jref = jax_reference_decode(
        jnp.asarray(q), jax_gather_kv_pages(jnp.asarray(kp), jnp.asarray(bt)),
        jax_gather_kv_pages(jnp.asarray(vp), jnp.asarray(bt)),
        jnp.asarray(vl), 0.25)
    ours = flash_decode_paged(T_(q), T_(kp), T_(vp), T_(bt), T_(vl), 0.25)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jref),
                               rtol=1e-5, atol=2e-5)


def test_paged_decode_ignores_scratch_and_stale_rows():
    """Rows past valid_len and the scratch block's content never reach
    the output."""
    rs = np.random.RandomState(3)
    q, kp, vp, bt, vl = _paged_inputs(rs, 2, 4, 2, 16, 8, 4, [11, 3])
    base = flash_decode_paged(T_(q), T_(kp), T_(vp), T_(bt), T_(vl))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = vp2[0] = 1e4                              # scratch block
    kp2[bt[0, 1], :, 3:] = vp2[bt[0, 1], :, 3:] = -1e4  # stale tail rows
    again = flash_decode_paged(T_(q), T_(kp2), T_(vp2), T_(bt), T_(vl))
    np.testing.assert_array_equal(base.numpy(), again.numpy())


def test_gather_kv_pages_matches_jax():
    rs = np.random.RandomState(4)
    pages = rs.randn(9, 2, 4, 8).astype(np.float32)
    bt = rs.randint(0, 9, (3, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_kv_pages(T_(pages), T_(bt)).numpy(),
        np.asarray(jax_gather_kv_pages(jnp.asarray(pages), jnp.asarray(bt))))


def test_reference_decode_matches_jax_contiguous():
    rs = np.random.RandomState(5)
    q = rs.randn(2, 8, 32).astype(np.float32)
    kc = rs.randn(2, 2, 20, 32).astype(np.float32)
    vc = rs.randn(2, 2, 20, 32).astype(np.float32)
    vl = np.asarray([20, 7], np.int32)
    np.testing.assert_allclose(
        reference_decode_attention(T_(q), T_(kc), T_(vc), T_(vl)).numpy(),
        np.asarray(jax_reference_decode(jnp.asarray(q), jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(vl))),
        rtol=1e-5, atol=2e-5)


# -- wrappers and the build ---------------------------------------------------

def test_cpu_tensors_launch_nothing():
    """On the CPU every wrapper takes its plain version: no launch is
    counted and the kernel library is never built."""
    _build.reset_launch_counts()
    rs = np.random.RandomState(6)
    x = T_(rs.randn(4, 64).astype(np.float32))
    rmsnorm(x, torch.ones(64), 1e-5)
    q = T_(rs.randn(1, 8, 2, 16).astype(np.float32))
    flash_attention_forward(q, q[:, :, :1].contiguous(),
                            q[:, :, :1].contiguous())
    q2, kp, vp, bt, vl = _paged_inputs(rs, 1, 2, 1, 16, 8, 2, [9])
    flash_decode_paged(T_(q2), T_(kp), T_(vp), T_(bt), T_(vl))
    q8 = quantize_kv(T_(kp), T_(vp))
    flash_decode_paged_quantized(T_(q2), *q8, T_(bt), T_(vl))
    c = gather_kv_pages(T_(kp), T_(bt))
    flash_decode(T_(q2), c, c, T_(vl))
    flash_decode_quantized(T_(q2), *quantize_kv(c, c), T_(vl))
    # the training step's kernels: forward statistics and backwards
    from mxnet_tpu_torch.kernels import flash_attention as tfa
    from mxnet_tpu_torch.kernels import fused_ce, fused_norm
    _, rrms = fused_norm.rmsnorm_fwd(x, torch.ones(64), 1e-5)
    fused_norm.rmsnorm_dx(x, torch.ones(64), rrms, x)
    k1 = q[:, :, :1].contiguous()
    out, lse = flash_attention_forward(q, k1, k1, return_lse=True)
    delta = tfa.attention_delta(out, q)
    tfa.flash_bwd_dq(q, k1, k1, q, lse, delta)
    tfa.flash_bwd_dkv(q, k1, k1, q, lse, delta)
    lbl = torch.tensor([1, 0, 63, 5], dtype=torch.int32)
    loss, lse = fused_ce.ce_fwd(x, lbl)
    fused_ce.ce_bwd(x, lbl, lse, loss)
    # BERT's LayerNorm, forward with its statistics and dx
    _, mu, rstd = fused_norm.layernorm_fwd(x, torch.ones(64),
                                           torch.zeros(64), 1e-5)
    fused_norm.layernorm_dx(x, torch.ones(64), mu, rstd, x)
    assert set(_build.launch_counts()) == {
        "mxtt_rmsnorm", "mxtt_flash_prefill", "mxtt_paged_decode",
        "mxtt_paged_decode_q8", "mxtt_contig_decode", "mxtt_contig_decode_q8",
        "mxtt_paged_window", "mxtt_rmsnorm_dx", "mxtt_flash_bwd_dq",
        "mxtt_flash_bwd_dkv", "mxtt_ce_fwd", "mxtt_ce_bwd",
        "mxtt_layernorm", "mxtt_layernorm_dx", "mxtt_flash_fwd_tc",
        "mxtt_flash_bwd_dq_tc", "mxtt_flash_bwd_dkv_tc"}
    assert all(n == 0 for n in _build.launch_counts().values())
    assert _build._lib is None


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_key_covers_every_source():
    srcs = {p.name for p in _build._sources()}
    assert {"common.cuh", "rmsnorm.cu", "flash_prefill.cu",
            "flash_backward.cu", "fused_ce.cu", "decode_attention.cu",
            "window_attention.cu", "layernorm.cu", "status.cu",
            "sm90.cuh", "flash_fwd_sm90.cu", "flash_bwd_dq_sm90.cu",
            "flash_bwd_dkv_sm90.cu"} <= srcs
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert path == _build.library_path()          # stable key

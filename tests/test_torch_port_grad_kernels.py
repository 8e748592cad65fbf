"""The training step's kernels on the CPU against the JAX package: each
plain version of the port (RMSNorm forward statistics and dx, the flash
forward's log-sum-exp, dQ and dK/dV, the fused softmax-CE forward and
backward) against the Pallas kernel it stands for, run in interpret
mode, and against the jnp path; then each autograd Function's gradients
against `jax.grad` through the JAX package's `custom_vjp`s with the
Pallas kernels in interpret mode (the env vars below), GQA with
rep > 1, ragged `lengths` and a batch row with no valid key included.

fp32 throughout; inputs from seeded numpy RNGs. Tolerances are fp32
reassociation (XLA and PyTorch sum in other orders, and the port sums a
GQA group's dK/dV in fp32 where the JAX kernel writes per-head values
first): 1e-5 relative plus 1e-5 absolute on O(1) values, 2e-5 for the
attention backward, whose dS terms cancel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.kernels import flash_attention as jfa
from mxnet_tpu.kernels import fused_ce as jce
from mxnet_tpu.kernels import fused_norm as jfn

from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import fused_ce as tce
from mxnet_tpu_torch.kernels import fused_norm as tfn

T_ = torch.from_numpy
INTERPRET = ("MXNET_TPU_FLASH_INTERPRET", "MXNET_TPU_NORM_INTERPRET",
             "MXNET_TPU_CE_INTERPRET")


def _close(ours, theirs, tol=1e-5):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=tol, atol=tol)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode; the test fails
    if any of them fell back to its jnp path."""
    for k in INTERPRET:
        monkeypatch.setenv(k, "1")
    before = [m.FALLBACK_COUNT for m in (jfa, jfn, jce)]
    yield
    assert [m.FALLBACK_COUNT for m in (jfa, jfn, jce)] == before


# -- RMSNorm ------------------------------------------------------------------

@pytest.mark.parametrize("rows,dim", [(8, 64), (37, 64), (5, 256)])
def test_rmsnorm_stats_and_dx_match_pallas_interpret_and_jnp(rows, dim):
    rs = np.random.RandomState(rows * dim)
    x = rs.randn(rows, dim).astype(np.float32) * 3
    g = (1 + 0.1 * rs.randn(dim)).astype(np.float32)
    dy = rs.randn(rows, dim).astype(np.float32)
    eps = 1e-5
    p_out, p_rrms = jfn._rms_pallas_fwd(jnp.asarray(x), jnp.asarray(g), eps,
                                        interpret=True)
    out, rrms = tfn.rmsnorm_fwd(T_(x), T_(g), eps)
    _close(out, p_out)
    _close(rrms, p_rrms)
    p_dx = jfn._rms_pallas_dx(jnp.asarray(x), jnp.asarray(g), p_rrms,
                              jnp.asarray(dy), eps, interpret=True)
    dx = tfn.rmsnorm_dx(T_(x), T_(g), rrms, T_(dy))
    _close(dx, p_dx)

    def jnp_rms(x_):                      # the JAX package's jnp route
        xs = x_.astype(jnp.float32)
        ms = jnp.mean(jnp.square(xs), axis=-1, keepdims=True)
        return xs * jax.lax.rsqrt(ms + eps) * jnp.asarray(g)
    _, vjp = jax.vjp(jnp_rms, jnp.asarray(x))
    _close(dx, vjp(jnp.asarray(dy))[0])


def test_rmsnorm_function_grads_match_jax_custom_vjp(interpret):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, 64).astype(np.float32)
    g = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    w = rs.randn(2, 9, 64).astype(np.float32)

    def jloss(x_, g_):
        return jnp.sum(jfn.fused_rmsnorm(x_, g_, eps=1e-5) * w)
    jdx, jdg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    tx, tg = T_(x).requires_grad_(), T_(g).requires_grad_()
    out = tfn.rmsnorm(tx, tg, 1e-5)
    assert type(out.grad_fn).__name__.startswith("RMSNormFunction")
    (out * T_(w)).sum().backward()
    _close(tx.grad, jdx)
    _close(tg.grad, jdg, tol=2e-5)


# -- flash attention ----------------------------------------------------------

LENGTHS = [None, [128, 77], [50, 0]]


def _attn_inputs(seed, B=2, T=128, H=4, K=2, d=16):
    rs = np.random.RandomState(seed)
    q, dout = (rs.randn(B, T, H, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, T, K, d).astype(np.float32) for _ in range(2))
    return q, k, v, dout


@pytest.mark.parametrize("lengths", LENGTHS)
def test_flash_lse_dq_dkv_match_pallas_interpret(lengths):
    q, k, v, dout = _attn_inputs(3 + (lengths or [0])[-1])
    scale = 0.25
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, dout))
    p_out, p_lse = jfa._pallas_forward(jq, jk, jv, True, scale,
                                       interpret=True, return_lse=True,
                                       lengths=jl)
    out, lse = tfa.flash_attention_forward(T_(q), T_(k), T_(v), True, scale,
                                           tl, return_lse=True)
    _close(out, p_out)
    finite = np.isfinite(np.asarray(p_lse))
    assert (torch.isfinite(lse).numpy() == finite).all()
    _close(lse[torch.from_numpy(finite)], np.asarray(p_lse)[finite])
    assert bool((lse[~torch.from_numpy(finite)] == float("inf")).all())

    delta = tfa.attention_delta(out, T_(dout))
    p_delta = jnp.sum(jdo * p_out, axis=-1).transpose(0, 2, 1)
    _close(delta, p_delta)
    p_dq, p_dk, p_dv = jfa._pallas_backward(
        jq, jk, jv, p_lse, p_delta, jdo, True, scale, interpret=True,
        lengths=jl)
    dq = tfa.flash_bwd_dq(T_(q), T_(k), T_(v), T_(dout), lse, delta, True,
                          scale, tl)
    dk, dv = tfa.flash_bwd_dkv(T_(q), T_(k), T_(v), T_(dout), lse, delta,
                               True, scale, tl)
    for ours, theirs in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        _close(ours, theirs, tol=2e-5)


@pytest.mark.parametrize("lengths", LENGTHS)
def test_flash_backward_plain_matches_jnp_vjp(lengths):
    """dQ, dK, dV of the plain versions against jax.vjp of the JAX
    package's jnp reference_attention."""
    q, k, v, dout = _attn_inputs(11)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out, vjp = jax.vjp(lambda a, b, c: jfa.reference_attention(
        a, b, c, True, 0.25, jl), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(dout))
    tout, lse = tfa.reference_attention_lse(T_(q), T_(k), T_(v), True, 0.25,
                                            tl)
    _close(tout, out)
    delta = tfa.attention_delta(tout, T_(dout))
    ours = (tfa.flash_bwd_dq_ref(T_(q), T_(k), T_(v), T_(dout), lse, delta,
                                 True, 0.25, tl),) \
        + tfa.flash_bwd_dkv_ref(T_(q), T_(k), T_(v), T_(dout), lse, delta,
                                True, 0.25, tl)
    for a, b in zip(ours, grads):
        _close(a, b, tol=2e-5)


@pytest.mark.parametrize("K", [4, 2, 1])
@pytest.mark.parametrize("lengths", LENGTHS)
def test_flash_function_grads_match_jax_custom_vjp(interpret, K, lengths):
    """FlashAttentionFunction against jax.grad of flash_attention_raw
    with the Pallas forward and backward in interpret mode: GQA rep 1, 2
    and 4, full, ragged and empty rows."""
    q, k, v, dout = _attn_inputs(5 * K, K=K)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention_raw(a, b, c, causal=True,
                                               lengths=jl) * dout)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (T_(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, True, None, tl)
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
    (out * T_(dout)).sum().backward()
    for ours, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(ours, theirs, tol=2e-5)


def test_flash_backward_is_causal_at_the_diagonal():
    """A key's gradient takes nothing from queries before it: moving dO
    of rows t < s leaves dK, dV of key s unchanged, and dQ of row t takes
    nothing from keys past t."""
    q, k, v, dout = _attn_inputs(17, B=1, T=64, H=2, K=1)
    args = [T_(a) for a in (q, k, v)]
    out, lse = tfa.reference_attention_lse(*args, True, 0.25)
    s = 40
    dout2 = dout.copy()
    dout2[:, :s] += 10.0
    dks = []
    for g in (dout, dout2):
        delta = tfa.attention_delta(out, T_(g))
        dks.append(tfa.flash_bwd_dkv(*args, T_(g), lse, delta, True, 0.25))
    for a, b in zip(*dks):
        assert torch.equal(a[:, s:], b[:, s:])
        assert not torch.equal(a[:, :s], b[:, :s])
    k2, v2 = k.copy(), v.copy()
    k2[:, s + 1:] += 5.0
    v2[:, s + 1:] += 5.0
    dqs = []
    for kk, vv in ((k, v), (k2, v2)):
        a2 = [T_(q), T_(kk), T_(vv)]
        o2, l2 = tfa.reference_attention_lse(*a2, True, 0.25)
        dqs.append(tfa.flash_bwd_dq(*a2, T_(dout), l2,
                                    tfa.attention_delta(o2, T_(dout)),
                                    True, 0.25))
    _close(dqs[0][:, :s + 1], dqs[1][:, :s + 1].numpy(), tol=1e-6)


# -- fused softmax cross-entropy ----------------------------------------------

@pytest.mark.parametrize("N,V", [(37, 1100), (16, 1024), (5, 4096)])
def test_ce_forward_backward_match_pallas_interpret_and_jnp(N, V):
    rs = np.random.RandomState(N + V)
    x = (rs.randn(N, V) * 4).astype(np.float32)
    lbl = rs.randint(0, V, N).astype(np.int32)
    g = rs.rand(N).astype(np.float32)
    p_loss, res = jce._ce_pallas_fwd(jnp.asarray(x), jnp.asarray(lbl), True)
    loss, lse = tce.ce_fwd(T_(x), T_(lbl))
    _close(loss, p_loss)
    _close(lse, np.asarray(res[2])[:N, 0])
    _close(loss, jce.reference_softmax_ce(jnp.asarray(x), jnp.asarray(lbl)))
    p_dx, _ = jce._ce_pallas_bwd(True, res, jnp.asarray(g))
    dx = tce.ce_bwd(T_(x), T_(lbl), lse, T_(g))
    _close(dx, p_dx)
    _, vjp = jax.vjp(lambda a: jce.reference_softmax_ce(a, jnp.asarray(lbl)),
                     jnp.asarray(x))
    _close(dx, vjp(jnp.asarray(g))[0])


def test_ce_function_grads_match_jax_custom_vjp(interpret):
    rs = np.random.RandomState(23)
    N, V = 24, 1536
    x = (rs.randn(N, V) * 3).astype(np.float32)
    lbl = rs.randint(0, V, N).astype(np.int32)
    w = rs.rand(N).astype(np.float32)

    def jloss(a):
        return jnp.sum(jce.fused_softmax_ce_raw(a, jnp.asarray(lbl)) * w)
    jdx = jax.grad(jloss)(jnp.asarray(x))
    tx = T_(x).requires_grad_()
    loss = tce.softmax_ce(tx, T_(lbl).long())
    assert type(loss.grad_fn).__name__.startswith("SoftmaxCEFunction")
    _close(loss, jce.fused_softmax_ce_raw(jnp.asarray(x), jnp.asarray(lbl)))
    (loss * T_(w)).sum().backward()
    _close(tx.grad, jdx)


def test_ce_gate_is_a_constant():
    assert not tce.eligible(tce.MIN_VOCAB - 1)
    assert tce.eligible(tce.MIN_VOCAB) and tce.eligible(1 << 20)

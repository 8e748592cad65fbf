"""LayerNorm of the port on the CPU against the JAX package: the plain
forward (out, mu, rstd) and dx against the Pallas `_ln_fwd_kernel` and
`_ln_bwd_kernel` run in interpret mode and against the jnp route, then
`LayerNormFunction`'s dx, dgamma and dbeta against `jax.grad` through
the JAX package's `_ln` custom_vjp with its Pallas kernels in interpret
mode (MXNET_TPU_NORM_INTERPRET=1, no fallback counted).

fp32 throughout; inputs from seeded numpy RNGs, each row shifted by its
own offset so that the centred (two-pass) variance matters. Tolerance
1e-5 relative plus 1e-5 absolute: fp32 reassociation (XLA and PyTorch
sum the row statistics in other orders) on O(1) values; 2e-5 for
dgamma and dbeta, sums over up to 18 rows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.kernels import fused_norm as jfn

from mxnet_tpu_torch.kernels import fused_norm as tfn

T_ = torch.from_numpy
EPS = 1e-5


def _close(ours, theirs, tol=1e-5):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=tol, atol=tol)


def _inputs(rows, dim, seed):
    rs = np.random.RandomState(seed)
    off = (4 * rs.randn(rows, 1)).astype(np.float32)
    x = (rs.randn(rows, dim) * 2 + off).astype(np.float32)
    g = (1 + 0.1 * rs.randn(dim)).astype(np.float32)
    b = (0.1 * rs.randn(dim)).astype(np.float32)
    dy = rs.randn(rows, dim).astype(np.float32)
    return x, g, b, dy


def _jnp_layernorm(x, g, b):
    """The JAX package's jnp route of `fused_layernorm`."""
    xs = x.astype(jnp.float32)
    mean = jnp.mean(xs, axis=-1, keepdims=True)
    var = jnp.var(xs, axis=-1, keepdims=True)
    return (xs - mean) * jax.lax.rsqrt(var + EPS) * g + b


@pytest.mark.parametrize("rows,dim", [(8, 64), (37, 64), (5, 768)])
def test_layernorm_stats_and_dx_match_pallas_interpret_and_jnp(rows, dim):
    x, g, b, dy = _inputs(rows, dim, rows * dim)
    jx, jg, jb = map(jnp.asarray, (x, g, b))
    p_out, p_mu, p_rstd = jfn._ln_pallas_fwd(jx, jg, jb, EPS, interpret=True)
    out, mu, rstd = tfn.layernorm_fwd(T_(x), T_(g), T_(b), EPS)
    _close(out, p_out)
    _close(mu, p_mu)
    _close(rstd, p_rstd)
    _close(out, _jnp_layernorm(jx, jg, jb))
    assert tfn.layernorm_fwd(T_(x), T_(g), T_(b), EPS,
                             with_stats=False)[1:] == (None, None)

    p_dx = jfn._ln_pallas_dx(jx, jg, p_mu, p_rstd, jnp.asarray(dy), EPS,
                             interpret=True)
    dx = tfn.layernorm_dx(T_(x), T_(g), mu, rstd, T_(dy))
    _close(dx, p_dx)
    _, vjp = jax.vjp(lambda a: _jnp_layernorm(a, jg, jb), jx)
    _close(dx, vjp(jnp.asarray(dy))[0])


def test_layernorm_function_grads_match_jax_custom_vjp(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_NORM_INTERPRET", "1")
    before = jfn.FALLBACK_COUNT
    x, g, b, w = _inputs(18, 96, 3)
    x, w = x.reshape(2, 9, 96), w.reshape(2, 9, 96)

    def jloss(x_, g_, b_):
        return jnp.sum(jfn.fused_layernorm(x_, g_, b_, eps=EPS) * w)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, g, b)))
    assert jfn.FALLBACK_COUNT == before
    tx, tg, tb = (T_(a).requires_grad_() for a in (x, g, b))
    out = tfn.layernorm(tx, tg, tb, EPS)
    assert type(out.grad_fn).__name__.startswith("LayerNormFunction")
    _close(out, jfn.fused_layernorm(*map(jnp.asarray, (x, g, b)), eps=EPS))
    (out * T_(w)).sum().backward()
    _close(tx.grad, jgrads[0])
    _close(tg.grad, jgrads[1], tol=2e-5)
    _close(tb.grad, jgrads[2], tol=2e-5)
    assert jfn.FALLBACK_COUNT == before


def test_layernorm_without_grad_writes_no_stats():
    """Where autograd needs no gradient the route is one forward without
    statistics and no Function."""
    x, g, b, _ = _inputs(4, 32, 5)
    with torch.no_grad():
        out = tfn.layernorm(T_(x).requires_grad_(), T_(g), T_(b), EPS)
    assert out.grad_fn is None
    _close(out, tfn.layernorm_ref(T_(x), T_(g), T_(b), EPS))


def test_layernorm_dx_needs_the_mean_term():
    """The x_hat * mean(gamma dy x_hat) term of dx is not negligible at
    these inputs: dropping it moves dx by far more than the tolerance."""
    x, g, b, dy = _inputs(8, 64, 9)
    _, mu, rstd = tfn.layernorm_fwd_ref(T_(x), T_(g), T_(b), EPS)
    dx = tfn.layernorm_dx_ref(T_(x), T_(g), mu, rstd, T_(dy))
    r = rstd[:, None]
    wdy = T_(dy) * T_(g)
    short = r * (wdy - wdy.mean(dim=-1, keepdim=True))
    assert float((dx - short).abs().max()) > 100 * 1e-5

"""The port's int8 KV cache on the CPU against the JAX package: the
quantizer (codes and scales bit-identical), the two int8 decode kernels'
plain versions against the Pallas kernels in interpret mode, the int8
page pool, and the int8 server against the port's int8 `generate()` and
the JAX int8 server (`llama_tiny` fp32, the same weights). Inputs come
from seeded numpy RNGs; cache rows get magnitudes that vary by token, so
the per-token scales differ widely.

Attention tolerances are fp32 reassociation (about 1e-6 relative) with
headroom. Token identity follows the margin rule of the serving tests:
a greedy token may differ only where the port's own top-2 logit margin
is under MARGIN.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.kernels.flash_decode import (
    _flash_decode_pallas_q8, _flash_decode_paged_pallas_q8,
    flash_decode_quantized as jax_flash_decode_quantized,
    quantize_kv as jax_quantize_kv)
from mxnet_tpu.serving import InferenceServer as JaxServer
from mxnet_tpu.serving import PagedKVCache as JaxCache
from mxnet_tpu.serving.executables import _quant_rows as jax_quant_rows

from mxnet_tpu_torch.kernels.flash_decode import (
    flash_decode_paged_quantized, flash_decode_quantized,
    gather_kv_pages, quantize_kv, reference_decode_attention)
from mxnet_tpu_torch.models import generate, get_model
from mxnet_tpu_torch.models.llama import load_jax_params
from mxnet_tpu_torch.models.llama_infer import build_decoder
from mxnet_tpu_torch.serving import InferenceServer, PagedKVCache
from mxnet_tpu_torch.serving.executables import _quant_rows

T_ = torch.from_numpy
MARGIN = 1e-4
CPU = "cpu"


def _rows(rs, *shape):
    """Normal rows scaled per token by e^(2 z): magnitudes over about
    four decades, so no two tokens share a scale."""
    x = rs.randn(*shape) * np.exp(2 * rs.randn(*shape[:-1], 1))
    return x.astype(np.float32)


# -- the quantizer ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_and_scales_equal_jax(dtype):
    rs = np.random.RandomState(0)
    k, v = _rows(rs, 2, 2, 40, 16), _rows(rs, 2, 2, 40, 16)
    k[0, 0, 3] = 0.0                              # an all-zero row
    v[1, 1, 5] = 0.0                              # scale 1: codes at .5
    v[1, 1, 5, :4] = [127.0, 0.5, 1.5, -2.5]      # round half to even
    tk, tv = T_(k), T_(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if dtype == "bfloat16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    ours = quantize_kv(tk, tv)
    theirs = jax_quantize_kv(jk, jv)
    for a, b in zip(ours, theirs):
        assert a.dtype == (torch.int8 if b.dtype == jnp.int8
                           else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(ours[1][0, 0, 3, 0]) == np.float32(1e-8 / 127.0)


def test_quant_rows_equal_jax():
    rs = np.random.RandomState(1)
    rows = _rows(rs, 9, 2, 16)
    for a, b in zip(_quant_rows(T_(rows)), jax_quant_rows(jnp.asarray(rows))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the int8 decode kernels' plain versions ---------------------------------

def _q8_cache(rs, B, K, S, d):
    k8, ks, v8, vs = jax_quantize_kv(jnp.asarray(_rows(rs, B, K, S, d)),
                                     jnp.asarray(_rows(rs, B, K, S, d)))
    return [np.array(a) for a in (k8, ks, v8, vs)]


@pytest.mark.parametrize("S,vls", [(64, [1, 64, 33]), (40, [40, 7, 21])])
def test_decode_quantized_plain_matches_pallas_interpret(S, vls):
    rs = np.random.RandomState(S)
    B, H, K, d = 3, 4, 2, 16
    q = rs.randn(B, H, d).astype(np.float32)
    cache = _q8_cache(rs, B, K, S, d)
    vl = np.asarray(vls, np.int32)
    pallas = _flash_decode_pallas_q8(jnp.asarray(q),
                                     *map(jnp.asarray, cache),
                                     jnp.asarray(vl), 0.25, interpret=True)
    jref = jax_flash_decode_quantized(jnp.asarray(q),
                                      *map(jnp.asarray, cache),
                                      jnp.asarray(vl), 0.25)
    ours = flash_decode_quantized(T_(q), *map(T_, cache), T_(vl), 0.25)
    assert ours.dtype == torch.float32
    for theirs in (pallas, jref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5)


def test_decode_quantized_plain_dequantizes_in_fp32_and_keeps_q_dtype():
    """The plain version attends over fp32 dequantized rows (not bf16)
    and returns q's dtype."""
    rs = np.random.RandomState(2)
    q = T_(rs.randn(2, 4, 16).astype(np.float32))
    k8, ks, v8, vs = map(T_, _q8_cache(rs, 2, 2, 24, 16))
    vl = torch.tensor([24, 9], dtype=torch.int32)
    want = reference_decode_attention(q, k8.float() * ks, v8.float() * vs,
                                      vl)
    np.testing.assert_array_equal(
        flash_decode_quantized(q, k8, ks, v8, vs, vl).numpy(), want.numpy())
    out = flash_decode_quantized(q.bfloat16(), k8, ks, v8, vs, vl)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("bs,vls", [(8, [1, 13, 32]), (16, [16, 33, 5])])
def test_paged_decode_quantized_plain_matches_pallas_interpret(bs, vls):
    rs = np.random.RandomState(bs + 100)
    B, H, K, d, nb = 3, 4, 2, 16, 64 // bs
    N = B * nb + 1
    q = rs.randn(B, H, d).astype(np.float32)
    pool = [np.array(a) for a in jax_quantize_kv(
        jnp.asarray(_rows(rs, N, K, bs, d)),
        jnp.asarray(_rows(rs, N, K, bs, d)))]
    ids = 1 + rs.permutation(N - 1)                 # shuffled blocks
    bt = np.zeros((B, nb), np.int32)
    for b, n in enumerate(vls):
        used = -(-n // bs)
        bt[b, :used] = ids[b * nb:b * nb + used]
    vl = np.asarray(vls, np.int32)
    pallas = _flash_decode_paged_pallas_q8(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(bt),
        jnp.asarray(vl), 0.25, interpret=True)
    ours = flash_decode_paged_quantized(T_(q), *map(T_, pool), T_(bt),
                                        T_(vl), 0.25)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    # the gathered view through the contiguous int8 plain version agrees
    # exactly: the paged plain version is gather + that
    g = [gather_kv_pages(T_(p), T_(bt)) for p in pool]
    np.testing.assert_array_equal(
        ours.numpy(), flash_decode_quantized(T_(q), *g, T_(vl), 0.25).numpy())


# -- the int8 pool and server ------------------------------------------------

def test_int8_pool_layout_matches_jax():
    args = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=5,
                block_size=4, batch_slots=2, max_blocks_per_seq=2)
    jp = JaxCache(**args, quantized=True).pages[1]
    tc = PagedKVCache(**args, quantized=True, device=CPU)
    assert tc.quantized and set(tc.pages[1]) == set(jp)
    for f, a in tc.pages[1].items():
        assert a.dtype == (torch.int8 if f in ("k", "v") else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(jp[f]))


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(0)
    jnet = mx.models.get_model("llama_tiny")
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))   # materialize
    tnet = get_model("llama_tiny", device=CPU)
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return jnet, tnet


@torch.no_grad()
def _int8_margin(tnet, prompt, prefix):
    """The port's int8 top-2 logit margin after `prompt` + `prefix`."""
    params, prefill, step = build_decoder(tnet, len(prompt) + len(prefix),
                                          kv_cache_dtype="int8")
    T = len(prompt)
    cache, logits = prefill(params, T_(prompt.astype(np.int64))[None],
                            torch.tensor([T], dtype=torch.int32))
    for i, t in enumerate(prefix):
        cache, logits = step(params, cache, torch.tensor([T + i]),
                             torch.tensor([int(t)]))
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1])


def _assert_same_tokens(tnet, prompt, ours, theirs):
    ours, theirs = list(ours), list(theirs)
    if ours == theirs:
        return
    i = next(j for j in range(len(ours)) if ours[j] != theirs[j])
    margin = _int8_margin(tnet, prompt, theirs[:i])
    assert margin < MARGIN, (f"token {i} differs ({ours[i]} vs "
                             f"{theirs[i]}) at a top-2 margin of {margin}")


def test_int8_server_matches_int8_generate_and_jax_server(nets):
    """tests/test_serving.py's int8 parity workload through the port's
    int8 server: token-identical to the port's one-shot int8 generate()
    and to the JAX int8 server."""
    jnet, tnet = nets
    kw = dict(batch_slots=2, max_len=64, block_size=8, max_prompt_len=12,
              kv_cache_dtype="int8")
    ts = InferenceServer(tnet, device=CPU, **kw)
    js = JaxServer(jnet, **kw)
    assert ts.cache.quantized and ts.kv_cache_dtype == "int8"
    reqs = []
    rs = np.random.RandomState(16)
    for _ in range(4):
        T = int(rs.randint(3, 13))
        p = rs.randint(0, 256, T).astype(np.int32)
        new = int(rs.randint(2, 9))
        reqs.append((p, new, ts.submit(p, max_new_tokens=new),
                     js.submit(p, max_new_tokens=new)))
    ts.run()
    js.run()
    for p, new, r, jr in reqs:
        assert r.status == "ok" and len(r.output_tokens) == new
        one = generate(tnet, p[None, :], max_new_tokens=new, max_len=64,
                       kv_cache_dtype="int8", device=CPU)
        _assert_same_tokens(tnet, p, r.output_tokens, one[0, len(p):])
        _assert_same_tokens(tnet, p, r.output_tokens, jr.output_tokens)
    ts.cache.check()


def test_server_rejects_unknown_cache_dtype(nets):
    _, tnet = nets
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        InferenceServer(tnet, device=CPU, kv_cache_dtype="fp8")

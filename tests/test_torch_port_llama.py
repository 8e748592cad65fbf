"""The port's Llama model on the CPU against the JAX package: the
layer-math functions one by one, the weight bridge, and the full forward
of `llama_tiny` with the same weights. Inputs come from a seeded numpy
RNG and go to both packages. fp32; tolerances are fp32 reassociation
(matmul and reduction order differ between XLA and PyTorch) with
headroom: 1e-5 absolute on O(1) activations.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import llama_math as jlm

from mxnet_tpu_torch.models import get_model, list_models
from mxnet_tpu_torch.models import llama_math as tlm
from mxnet_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          load_jax_params)
from mxnet_tpu_torch.models.llama_infer import _params_tree

ATOL = 1e-5
D, H, K, d, I = 64, 4, 2, 16, 128


def _layer(rs):
    def w(*shape):
        return (rs.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32)
    return {"ln1": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "wq": w(H * d, D), "wk": w(K * d, D), "wv": w(K * d, D),
            "wo": w(D, H * d),
            "ln2": (1 + 0.1 * rs.randn(D)).astype(np.float32),
            "gate": w(I, D), "up": w(I, D), "down": w(D, I)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=1e-5, atol=atol)


@pytest.fixture(scope="module")
def jax_tiny():
    mx.random.seed(0)
    net = mx.models.get_model("llama_tiny")
    net.initialize()
    net(mx.nd.array(np.zeros((1, 4)), dtype="int32"))   # materialize
    return net


@pytest.fixture(scope="module")
def torch_tiny(jax_tiny):
    net = get_model("llama_tiny", device="cpu")
    load_jax_params(net, {k: p.data().asnumpy()
                          for k, p in jax_tiny.collect_params().items()})
    return net


# -- llama_math, function by function ----------------------------------------

def test_rms_matches_jax_at_config_eps():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, D).astype(np.float32)
    g = (1 + 0.1 * rs.randn(D)).astype(np.float32)
    _close(tlm.rms(torch.from_numpy(x), torch.from_numpy(g), 1e-5),
           jlm.rms(jnp.asarray(x), jnp.asarray(g), 1e-5))


@pytest.mark.parametrize("pos_shape", ["shared", "per_row"])
def test_rope_at_matches_jax(pos_shape):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, H, d).astype(np.float32)
    pos = np.arange(6) + 3 if pos_shape == "shared" else \
        rs.randint(0, 100, (2, 6))
    _close(tlm.rope_at(torch.from_numpy(x), torch.from_numpy(pos), 5e5),
           jlm.rope_at(jnp.asarray(x), jnp.asarray(pos), 5e5))


def test_rope_rotates_halves_not_pairs():
    """Position 1 rotates element i against element i + d/2."""
    x = torch.zeros(1, 1, 1, d)
    x[..., 0] = 1.0
    out = tlm.rope_at(x, torch.tensor([1]), 10000.0)[0, 0, 0]
    assert out[d // 2] == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[1] == 0.0


def test_layer_qkv_swiglu_and_finish_match_jax():
    rs = np.random.RandomState(2)
    lp = _layer(rs)
    x = rs.randn(2, 7, D).astype(np.float32)
    pos = np.arange(7)
    for ours, theirs in zip(
            tlm.layer_qkv(_t(lp), torch.from_numpy(x), torch.from_numpy(pos),
                          1e-5, 5e5, H, K, d),
            jlm.layer_qkv(_j(lp), jnp.asarray(x), jnp.asarray(pos), 1e-5,
                          5e5, H, K, d)):
        _close(ours, theirs)
    _close(tlm.swiglu(torch.from_numpy(x), *(torch.from_numpy(lp[k])
                                              for k in ("gate", "up",
                                                        "down"))),
           jlm.swiglu(jnp.asarray(x), *(jnp.asarray(lp[k])
                                        for k in ("gate", "up", "down"))))
    att = rs.randn(2, 7, H, d).astype(np.float32)
    _close(tlm.layer_finish(_t(lp), torch.from_numpy(x),
                            torch.from_numpy(att), 1e-5),
           jlm.layer_finish(_j(lp), jnp.asarray(x), jnp.asarray(att), 1e-5))


@pytest.mark.parametrize("lengths", [None, [9, 4]])
def test_decoder_layer_matches_jax(lengths):
    rs = np.random.RandomState(3)
    lp = _layer(rs)
    x = rs.randn(2, 9, D).astype(np.float32)
    pos = np.arange(9)
    tl = None if lengths is None else torch.tensor(lengths,
                                                   dtype=torch.int32)
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ours = tlm.decoder_layer(_t(lp), torch.from_numpy(x),
                             torch.from_numpy(pos), 1e-5, 5e5, H, K, d,
                             lengths=tl, return_kv=True)
    theirs = jlm.decoder_layer(_j(lp), jnp.asarray(x), jnp.asarray(pos),
                               1e-5, 5e5, H, K, d, lengths=jl,
                               return_kv=True)
    for a, b in zip(ours, theirs):
        _close(a, b)


def test_final_logits_matches_jax():
    rs = np.random.RandomState(4)
    params = {"norm": (1 + 0.1 * rs.randn(D)).astype(np.float32),
              "head": (rs.randn(32, D) / 8).astype(np.float32)}
    x = rs.randn(2, 3, D).astype(np.float32)
    _close(tlm.final_logits(_t(params), torch.from_numpy(x), 1e-5),
           jlm.final_logits(_j(params), jnp.asarray(x), 1e-5))


# -- the weight bridge and the model ------------------------------------------

def test_bridge_lands_every_name_shape_and_dtype(jax_tiny, torch_tiny):
    jp = {k: p.data().asnumpy() for k, p in jax_tiny.collect_params().items()}
    tp = dict(torch_tiny.named_parameters())
    assert set(jp) == set(tp)
    for name, a in jp.items():
        t = tp[name]
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == torch.float32 and a.dtype == np.float32, name
        np.testing.assert_array_equal(t.detach().numpy(), a, err_msg=name)
    tree = _params_tree(torch_tiny)
    assert len(tree["layers"]) == 2
    assert tree["embed"].shape == (256, 64)
    assert tree["layers"][0]["wk"].shape == (K * d, D)


def test_bridge_rejects_mismatches(jax_tiny):
    jp = {k: p.data().asnumpy() for k, p in jax_tiny.collect_params().items()}
    net = get_model("llama_tiny", device="cpu")
    with pytest.raises(KeyError, match="model.norm.gamma"):
        load_jax_params(net, {k: v for k, v in jp.items()
                              if k != "model.norm.gamma"})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(net, {**jp, "lm_head.weight": jp["lm_head.weight"].T})
    with pytest.raises(TypeError, match="dtype"):
        load_jax_params(net, {**jp, "model.norm.gamma":
                              jp["model.norm.gamma"].astype(np.float64)})


def test_bridge_bf16_weights():
    """bf16 arrays (ml_dtypes on the JAX side) land bit for bit; norm
    gains stay float32 as in the JAX package."""
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_layers=1, num_heads=2, num_kv_heads=1, dtype="bfloat16")
    mx.random.seed(1)
    jnet = mx.models.llama.LlamaForCausalLM(mx.models.llama.LlamaConfig(**kw))
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 2)), dtype="int32"))
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_jax_params(tnet, jp)
    for name, t in tnet.named_parameters():
        want = torch.float32 if name.endswith("gamma") else torch.bfloat16
        assert t.dtype == want, name
        np.testing.assert_array_equal(t.detach().float().numpy(),
                                      jp[name].astype(np.float32))


def test_full_forward_matches_jax(jax_tiny, torch_tiny):
    ids = np.random.RandomState(5).randint(0, 256, (2, 11)).astype(np.int32)
    theirs = jax_tiny(mx.nd.array(ids, dtype="int32")).asnumpy()
    with torch.no_grad():
        ours = torch_tiny(torch.from_numpy(ids).long())
    _close(ours, theirs)


def test_registry_and_seeded_init():
    assert list_models() == ["bert_base", "bert_large", "bert_tiny",
                             "llama_3_8b", "llama_tiny", "transformer_base",
                             "transformer_tiny"]
    with pytest.raises(ValueError, match="unknown model"):
        get_model("llama_70b", device="cpu")
    a = get_model("llama_tiny", device="cpu")
    b = get_model("llama_tiny", device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith("gamma"):
            assert bool((p == 1).all())
        else:
            assert abs(float(p.detach().std()) - 0.02) < 0.005, n

"""bf16 parity with the JAX package on the CPU: a `llama_tiny`-shaped
config (vocab 256, hidden 64, 2 layers, 4 / 2 heads) built in bfloat16
in both packages (`LlamaConfig(..., dtype="bfloat16")` directly: both
factories pin fp32) with the same weights, through the full forward,
`generate()` and the paged server.

Tolerance. Both packages keep fp32 statistics and accumulate products
in fp32, and both round activations to bf16 after every projection,
norm and attention, but not at the same points or from the same sums
(XLA and PyTorch reassociate; the JAX reference casts P to v's dtype
before P @ V, flash_attention.py:61, which the port's plain version does
too). Neither is nearer to exact: each stands about one bf16 step of
the logits from an fp32 copy of the same weights. So the port's bf16
logits may differ from JAX's by at most TOL_FACTOR x the JAX bf16
logits' own distance from the fp32 forward (the sum of the two
distances, with each bounded by the larger), and the port may stand no
further from fp32 than that either. Measured: JAX 0.0074 from fp32, the
port 0.0070, the two 0.0078 apart (one bf16 step at |logit| ~1).

Greedy tokens are held identical wherever the port's own bf16 top-2
margin at the first differing token is at least twice the tolerance (a
gap between two logits moves by at most twice their largest change).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import llama_infer as jinfer
from mxnet_tpu.models.llama import LlamaConfig as JaxConfig
from mxnet_tpu.models.llama import LlamaForCausalLM as JaxLlama
from mxnet_tpu.serving import InferenceServer as JaxServer

from mxnet_tpu_torch.models import generate
from mxnet_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          load_jax_params)
from mxnet_tpu_torch.serving import InferenceServer

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128)
CPU = "cpu"
TOL_FACTOR = 2.0


@pytest.fixture(scope="module")
def nets():
    """(JAX bf16 net, port bf16 net, port fp32 copy) with one set of
    weights."""
    mx.random.seed(0)
    jnet = JaxLlama(JaxConfig(**CFG, dtype="bfloat16"))
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))   # materialize
    tnet = LlamaForCausalLM(LlamaConfig(**CFG, dtype="bfloat16"), device=CPU)
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    t32 = LlamaForCausalLM(LlamaConfig(**CFG, dtype="float32"), device=CPU)
    with torch.no_grad():
        for a, b in zip(t32.parameters(), tnet.parameters()):
            a.copy_(b.float())
    return jnet, tnet, t32


@pytest.fixture(scope="module")
def tol(nets):
    """TOL_FACTOR x the JAX bf16 forward's distance from fp32, over the
    logits of two 11-token prompts."""
    jnet, _, t32 = nets
    ids = np.random.RandomState(5).randint(0, 256, (2, 11)).astype(np.int32)
    theirs = jnet(mx.nd.array(ids, dtype="int32")).asnumpy() \
        .astype(np.float32)
    with torch.no_grad():
        truth = t32(torch.from_numpy(ids).long()).numpy()
    return TOL_FACTOR * float(np.abs(theirs - truth).max())


def test_forward_logits_match_jax_in_bf16(nets, tol):
    jnet, tnet, t32 = nets
    for seed, shape in ((5, (2, 11)), (6, (3, 29)), (7, (1, 64))):
        ids = np.random.RandomState(seed).randint(0, 256, shape) \
            .astype(np.int32)
        theirs = jnet(mx.nd.array(ids, dtype="int32")).asnumpy() \
            .astype(np.float32)
        with torch.no_grad():
            ours = tnet(torch.from_numpy(ids).long())
            truth = t32(torch.from_numpy(ids).long()).numpy()
        assert ours.dtype == torch.bfloat16
        ours = ours.float().numpy()
        assert np.abs(ours - theirs).max() <= tol, (shape, tol)
        assert np.abs(ours - truth).max() <= tol, (shape, tol)
    # not vacuous: a bf16 step at these logits, and bf16 is not fp32
    assert 1e-3 < tol < 0.05


@torch.no_grad()
def _margin(tnet, seq):
    logits = tnet(torch.from_numpy(np.asarray(seq, np.int64))[None])[0, -1]
    top2 = logits.float().topk(2).values
    return float(top2[0] - top2[1])


def _assert_same_tokens(tnet, prompt, ours, theirs, tol):
    """Equal, or first different where the port's top-2 margin is under
    2 x tol."""
    ours, theirs = list(ours), list(theirs)
    n = min(len(ours), len(theirs))
    i = next((j for j in range(n) if ours[j] != theirs[j]), n)
    if i == n:
        assert len(ours) == len(theirs)
        return
    m = _margin(tnet, np.concatenate([prompt, np.asarray(theirs[:i])]))
    assert m < 2 * tol, (f"token {i} differs ({ours[i]} vs {theirs[i]}) at "
                         f"a top-2 margin of {m} >= 2 x {tol}")


def test_generate_matches_jax_in_bf16(nets, tol):
    jnet, tnet, _ = nets
    rs = np.random.RandomState(2)
    prompts = rs.randint(0, 256, (4, 9)).astype(np.int32)
    vls = [9, 3, 5, 7]
    ours = generate(tnet, prompts, 8, valid_len=vls, device=CPU)
    theirs = np.asarray(jinfer.generate(jnet, prompts, 8,
                                        valid_len=np.asarray(vls)))
    np.testing.assert_array_equal(ours[:, :9], prompts)
    for b in range(4):
        _assert_same_tokens(tnet, prompts[b, :vls[b]], ours[b, 9:],
                            theirs[b, 9:], tol)


def test_served_run_matches_jax_server_in_bf16(nets, tol):
    jnet, tnet, _ = nets
    kw = dict(batch_slots=4, max_len=64, block_size=8, max_prompt_len=12)
    js = JaxServer(jnet, **kw)
    ts = InferenceServer(tnet, device=CPU, **kw)
    rs = np.random.RandomState(12)
    reqs = []
    for _ in range(10):
        p = rs.randint(0, 256, int(rs.randint(3, 13))).astype(np.int32)
        new = int(rs.randint(2, 9))
        reqs.append((p, js.submit(p, max_new_tokens=new),
                     ts.submit(p, max_new_tokens=new)))
    js.run()
    ts.run()
    for p, a, b in reqs:
        assert b.status == "ok" and len(b.output_tokens) == len(
            a.output_tokens)
        _assert_same_tokens(tnet, p, b.output_tokens, a.output_tokens, tol)
    assert ts.stats()["kv_used_blocks"] == 0
    assert ts.cache.pages[0]["k"].dtype == torch.bfloat16

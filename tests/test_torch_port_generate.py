"""The port's contiguous-cache generation on the CPU against the JAX
package: the contiguous decode kernel's plain version against the Pallas
kernel in interpret mode and the jnp reference, `build_decoder`'s prefill
and step, `generate()` (greedy, ragged, eos, the max_len cap, sampled
rows) and `generate_beam()`, on `llama_tiny` fp32 with the same weights.
Inputs come from seeded numpy RNGs.

Logits agree with JAX to fp32 reassociation (about 1e-6); tolerances
carry headroom. Greedy token identity is asserted wherever the port's
own top-2 logit margin at the first differing token is at least MARGIN:
only a near-tie can flip a token. Sampled streams differ from JAX by
design (one torch.Generator per row), so sampled rows are held to the
kept top-k/top-p set instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.kernels.flash_decode import (
    _flash_decode_pallas, reference_decode_attention as jax_reference_decode)
from mxnet_tpu.models import llama_infer as jinfer

from mxnet_tpu_torch.kernels.flash_decode import flash_decode
from mxnet_tpu_torch.models import generate, generate_beam, get_model
from mxnet_tpu_torch.models.beam_search import beam_expand_topk
from mxnet_tpu_torch.models.llama import load_jax_params
from mxnet_tpu_torch.models.llama_infer import build_decoder
from mxnet_tpu_torch.serving import filter_logits

T_ = torch.from_numpy
MARGIN = 1e-4
CPU = "cpu"


# -- the contiguous decode kernel's plain version ----------------------------

@pytest.mark.parametrize("S,vls", [(64, [1, 64, 33]), (40, [40, 1, 17]),
                                   (128, [100, 128, 2])])
def test_decode_plain_matches_pallas_interpret_and_jnp(S, vls):
    rs = np.random.RandomState(S)
    B, H, K, d = 3, 4, 2, 16
    q = rs.randn(B, H, d).astype(np.float32)
    k = rs.randn(B, K, S, d).astype(np.float32)
    v = rs.randn(B, K, S, d).astype(np.float32)
    vl = np.asarray(vls, np.int32)
    pallas = _flash_decode_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(vl), 0.25,
                                  interpret=True)
    jref = jax_reference_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(vl), 0.25)
    ours = flash_decode(T_(q), T_(k), T_(v), T_(vl), 0.25)
    for theirs in (pallas, jref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5)
    # rows at or past valid_len never reach the output
    short = T_(np.minimum(vl, vl.min()))
    base = flash_decode(T_(q), T_(k), T_(v), short, 0.25)
    k[:, :, vl.min():] = v[:, :, vl.min():] = 1e4
    np.testing.assert_array_equal(
        flash_decode(T_(q), T_(k), T_(v), short, 0.25).numpy(), base.numpy())


# -- the model ---------------------------------------------------------------

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
def _margin(tnet, prompt, prefix, kv):
    """The port's top-2 logit margin after `prompt` + `prefix` through
    its own decoder and cache dtype."""
    T = len(prompt)
    params, prefill, step = build_decoder(tnet, T + len(prefix), kv)
    cache, logits = prefill(params, T_(np.asarray(prompt, np.int64))[None],
                            torch.tensor([T], dtype=torch.int32))
    for i, t in enumerate(prefix):
        cache, logits = step(params, cache, torch.tensor([T + i]),
                             torch.tensor([int(t)]))
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1])


def _assert_rows_match(tnet, prompts, vls, ours, theirs, kv="model",
                       stop=None):
    """Row by row: the generated columns are equal, or first differ at a
    near-tie of the port's logits. `stop` (eos) ends the comparison of a
    row after it."""
    T = prompts.shape[1]
    for b in range(len(prompts)):
        a, t = list(ours[b, T:]), list(theirs[b, T:])
        if a == t:
            continue
        i = next(j for j in range(len(a)) if a[j] != t[j])
        if stop is not None and stop in t[:i]:
            continue
        m = _margin(tnet, prompts[b, :vls[b]], t[:i], kv)
        assert m < MARGIN, (f"row {b} token {i} differs ({a[i]} vs {t[i]}) "
                            f"at a top-2 margin of {m}")


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_prefill_and_steps_match_jax_decoder(nets, kv):
    jnet, tnet = nets
    rs = np.random.RandomState(1)
    T, extra = 5, 3
    ids = rs.randint(0, 256, (2, T + extra)).astype(np.int32)
    vl = np.asarray([T, 3], np.int32)
    jp, jpre, jstep = jinfer.build_decoder(jnet, max_len=16,
                                           kv_cache_dtype=kv)
    jc, jl = jax.jit(jpre)(jp, jnp.asarray(ids[:, :T]), jnp.asarray(vl))
    tp, tpre, tstep = build_decoder(tnet, 16, kv)
    with torch.no_grad():
        tc, tl = tpre(tp, T_(ids[:, :T]).long(), T_(vl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5)
        assert set(tc[0]) == set(jc[0])
        for f, a in tc[1].items():
            assert a.shape == jc[1][f].shape
            if kv == "model":
                np.testing.assert_allclose(a.numpy(), np.asarray(jc[1][f]),
                                           rtol=1e-5, atol=1e-5)
        jst = jax.jit(jstep)
        for j in range(extra):
            pos = vl + j
            jc, jl = jst(jp, jc, jnp.asarray(pos), jnp.asarray(ids[:, T + j]))
            tc, tl = tstep(tp, tc, T_(pos).long(), T_(ids[:, T + j]).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_generate_greedy_ragged_matches_jax(nets, kv):
    jnet, tnet = nets
    rs = np.random.RandomState(2)
    prompts = rs.randint(0, 256, (3, 7)).astype(np.int32)
    vls = [7, 3, 5]
    ours = generate(tnet, prompts, 6, valid_len=vls, kv_cache_dtype=kv,
                    device=CPU)
    theirs = jinfer.generate(jnet, prompts, 6, valid_len=np.asarray(vls),
                             kv_cache_dtype=kv)
    assert ours.shape == (3, 13) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours[:, :7], prompts)
    _assert_rows_match(tnet, prompts, vls, ours, theirs, kv)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_generate_eos_and_max_len_cap_match_jax(nets, kv):
    """eos freezes a row (8-step chunks, early exit once every row is
    done; return_finished gives the eos index), and a max_len below the
    padded chunks takes one exact-size chunk."""
    jnet, tnet = nets
    rs = np.random.RandomState(3)
    prompts = rs.randint(0, 256, (2, 6)).astype(np.int32)
    first = generate(tnet, prompts, 1, kv_cache_dtype=kv, device=CPU)
    eos = int(first[0, -1])
    for max_len in (None, 16):
        ours, fin = generate(tnet, prompts, 10, eos_id=eos, max_len=max_len,
                             kv_cache_dtype=kv, return_finished=True,
                             device=CPU)
        theirs, jfin = jinfer.generate(jnet, prompts, 10, eos_id=eos,
                                       max_len=max_len, kv_cache_dtype=kv,
                                       return_finished=True)
        _assert_rows_match(tnet, prompts, [6, 6], ours, theirs, kv, stop=eos)
        assert fin[0] == 0 and jfin[0] == 0
        assert (ours[0, 6:] == eos).all()
        for b in range(2):
            if (ours[b] == theirs[b]).all():
                assert fin[b] == jfin[b]
    with pytest.raises(ValueError, match="max_len"):
        generate(tnet, prompts, 10, max_len=12, device=CPU)


def test_generate_sampled_rows_stay_in_kept_set(nets):
    """Per-row params: a greedy row equals greedy generate(); sampled rows
    draw only tokens inside the kept top-k/top-p set of the logits they
    were drawn from, and one seed gives one stream."""
    _, tnet = nets
    rs = np.random.RandomState(4)
    prompts = rs.randint(0, 256, (3, 5)).astype(np.int32)
    temps, top_k, top_p = [0.0, 0.8, 1.3], [0, 5, 0], [0.0, 0.0, 0.7]
    out = generate(tnet, prompts, 6, temperature=temps, top_k=top_k,
                   top_p=top_p, seed=7, device=CPU)
    assert (out == generate(tnet, prompts, 6, temperature=temps,
                            top_k=top_k, top_p=top_p, seed=7,
                            device=CPU)).all()
    greedy = generate(tnet, prompts, 6, device=CPU)
    np.testing.assert_array_equal(out[0], greedy[0])
    params, prefill, step = build_decoder(tnet, 11)
    with torch.no_grad():
        cache, logits = prefill(params, T_(prompts).long(),
                                torch.full((3,), 5, dtype=torch.int32))
        for j in range(6):
            kept = torch.isfinite(filter_logits(
                logits, torch.tensor(temps), torch.tensor(top_k),
                torch.tensor(top_p)))
            tok = T_(out[:, 5 + j]).long()
            assert bool(kept[torch.arange(3), tok].all()), j
            cache, logits = step(params, cache, torch.full((3,), 5 + j), tok)


def test_generate_beam_matches_jax(nets):
    jnet, tnet = nets
    rs = np.random.RandomState(9)
    prompts = rs.randint(0, 256, (2, 5)).astype(np.int32)
    ours = generate_beam(tnet, prompts, 6, beam_size=3, device=CPU)
    theirs = np.asarray(jinfer.generate_beam(jnet, prompts, 6, beam_size=3))
    np.testing.assert_array_equal(ours, theirs)
    greedy = generate(tnet, prompts, 6, device=CPU)
    np.testing.assert_array_equal(
        generate_beam(tnet, prompts, 6, beam_size=1, device=CPU), greedy)
    # eos: row 0's greedy first token freezes the beams that emit it
    eos = int(greedy[0, 5])
    ours = generate_beam(tnet, prompts, 6, beam_size=3, eos_id=eos,
                         device=CPU)
    theirs = np.asarray(jinfer.generate_beam(jnet, prompts, 6, beam_size=3,
                                             eos_id=eos))
    np.testing.assert_array_equal(ours, theirs)


def test_beam_expand_topk_matches_jax():
    from mxnet_tpu.models.beam_search import beam_expand_topk as jax_expand
    rs = np.random.RandomState(10)
    scores = rs.randn(2, 3).astype(np.float32)
    scores[1, 1:] = -np.inf
    logp = np.log(rs.dirichlet(np.ones(11), (2, 3))).astype(np.float32)
    fin = np.asarray([[False, True, False], [False, False, False]])
    for eos in (None, 4):
        ours = beam_expand_topk(T_(scores), T_(logp), T_(fin), eos)
        theirs = jax_expand(jnp.asarray(scores), jnp.asarray(logp),
                            jnp.asarray(fin), eos)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_weight_perturbation_moves_prefill_and_step_together(nets):
    """One weight change moves the port's prefill and step logits by the
    same amounts as the full forward's (the single-source contract of
    tests/test_llama_infer.py)."""
    _, tnet = nets
    rs = np.random.RandomState(13)
    T = 5
    ids = T_(rs.randint(0, 256, (2, T + 1))).long()

    @torch.no_grad()
    def all_paths():
        full = tnet(ids)
        params, prefill, step = build_decoder(tnet, 16)
        cache, pre = prefill(params, ids[:, :T],
                             torch.full((2,), T, dtype=torch.int32))
        _, st = step(params, cache, torch.full((2,), T), ids[:, T])
        return full[:, T - 1], pre, full[:, T], st

    f0_pre, p0, f0_step, s0 = all_paths()
    gate = tnet.model.layers[0].mlp.gate_proj.weight
    orig = gate.detach().clone()
    try:
        with torch.no_grad():
            gate.add_(0.05 * torch.sign(orig))
        f1_pre, p1, f1_step, s1 = all_paths()
    finally:
        with torch.no_grad():
            gate.copy_(orig)
    assert float((f1_pre - f0_pre).abs().max()) > 1e-4
    np.testing.assert_allclose((p1 - p0).numpy(), (f1_pre - f0_pre).numpy(),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose((s1 - s0).numpy(), (f1_step - f0_step).numpy(),
                               rtol=2e-3, atol=2e-4)

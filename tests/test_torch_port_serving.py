"""The port's serving slice on the CPU against the JAX package: the paged
KV allocator, per-row sampling, and the whole server — `llama_tiny` fp32
with the same weights behind the JAX `InferenceServer` and the port's,
fed the same requests. Inputs come from seeded numpy RNGs.

Token identity is asserted wherever the JAX model's top-2 logit margin
at the first differing step is at least MARGIN: the two packages agree
on logits to about 1e-6 (fp32 reassociation), so only a near-tie can
flip a greedy token, and MARGIN leaves two orders of headroom.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.serving import InferenceServer as JaxServer
from mxnet_tpu.serving import PagedKVCache as JaxCache

from mxnet_tpu_torch.models import get_model
from mxnet_tpu_torch.models.llama import load_jax_params
from mxnet_tpu_torch.serving import (InferenceServer, PagedKVCache,
                                     ServerStalledError, filter_logits,
                                     sample_tokens)

MARGIN = 1e-4
CPU = "cpu"


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


def _assert_same_tokens(tnet, prompt, ours, theirs):
    ours, theirs = list(ours), list(theirs)
    if ours == theirs:
        return
    n = min(len(ours), len(theirs))
    i = next((j for j in range(n) if ours[j] != theirs[j]), n)
    assert i < n, f"lengths differ: {ours} vs {theirs}"
    seq = np.concatenate([prompt, np.asarray(theirs[:i], np.int32)])
    with torch.no_grad():
        logits = tnet(torch.from_numpy(seq)[None].long())[0, -1]
    top2 = logits.topk(2).values
    margin = float(top2[0] - top2[1])
    assert margin < MARGIN, (f"token {i} differs ({ours[i]} vs "
                             f"{theirs[i]}) at a top-2 margin of {margin}")


def _submit_mixed(server, rs, n):
    out = []
    for _ in range(n):
        T = int(rs.randint(3, server.max_prompt_len + 1))
        p = rs.randint(0, 256, T).astype(np.int32)
        new = int(rs.randint(2, 9))
        out.append((p, server.submit(p, max_new_tokens=new)))
    return out


# -- PagedKVCache ---------------------------------------------------------------

def _caches(**kw):
    args = dict(num_layers=2, num_kv_heads=2, head_dim=8, num_blocks=13,
                block_size=4, batch_slots=4, max_blocks_per_seq=3)
    args.update(kw)
    return JaxCache(**args), PagedKVCache(**args, device=CPU)


def test_kv_cache_same_ops_same_tables_and_stats():
    """One alloc/ensure/free sequence through both allocators: equal
    return values, block tables and stats at every step."""
    jc, tc = _caches()
    rs = np.random.RandomState(0)
    held = {}
    for _ in range(300):
        slot = int(rs.randint(4))
        op = rs.randint(3)
        if slot in held and op == 0:
            jc.free_slot(slot)
            tc.free_slot(slot)
            del held[slot]
        elif slot in held:
            pos = min(held[slot], 11)
            assert jc.ensure(slot, pos) == tc.ensure(slot, pos)
            held[slot] = pos + 1
        else:
            n = int(rs.randint(1, 12))
            ok = jc.alloc(slot, n)
            assert tc.alloc(slot, n) == ok
            if ok:
                held[slot] = n
        np.testing.assert_array_equal(tc.block_tables, jc.block_tables)
        js = jc.stats()
        assert tc.stats() == {k: js[k] for k in tc.stats()}
        for s in range(4):
            assert tc.slot_blocks(s) == jc.slot_blocks(s)
            assert tc.slot_len(s) == jc.slot_len(s)
        tc.check()
        jc.check()


def test_kv_cache_pools_and_validation():
    _, tc = _caches()
    assert len(tc.pages) == 2
    assert tc.pages[0]["k"].shape == (13, 2, 4, 8)
    assert tc.pages[0]["v"].dtype == torch.float32
    assert tc.num_free_blocks == 12 and tc.blocks_for(0) == 1
    assert tc.can_alloc(12) and not tc.can_alloc(13 * 4)
    with pytest.raises(ValueError, match="scratch"):
        PagedKVCache(num_layers=1, num_kv_heads=1, head_dim=8, num_blocks=1,
                     block_size=4, batch_slots=1, max_blocks_per_seq=1,
                     device=CPU)
    with pytest.raises(ValueError, match="max_blocks_per_seq"):
        tc.alloc(0, 13)
    assert tc.alloc(0, 4)
    with pytest.raises(ValueError, match="already holds"):
        tc.alloc(0, 4)
    with pytest.raises(ValueError, match="exceeds"):
        tc.ensure(0, 12)


# -- sampling -----------------------------------------------------------------

def _jax_kept(logits, t, k, p):
    """sampling.py:33-51 in jnp: the logits left finite after the
    temperature, top-k and nucleus cuts."""
    lg0 = jnp.asarray(logits, jnp.float32)
    t = jnp.asarray(t)
    lg = lg0 / jnp.where(t > 0, t, 1.0)[:, None]
    V = lg.shape[-1]
    k = jnp.asarray(k, jnp.int32)
    asc = jnp.sort(lg, axis=-1)
    kth = jnp.take_along_axis(asc, jnp.clip(V - k, 0, V - 1)[:, None],
                              axis=-1)
    lg = jnp.where((k > 0)[:, None] & (lg < kth), -jnp.inf, lg)
    p = jnp.asarray(p, jnp.float32)
    desc = jnp.sort(lg, axis=-1)[:, ::-1]
    import jax
    probs = jax.nn.softmax(desc, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = cum - probs < p[:, None]
    thresh = jnp.min(jnp.where(keep, desc, jnp.inf), axis=-1, keepdims=True)
    use_p = (p > 0) & (p < 1)
    lg = jnp.where(use_p[:, None] & (lg < thresh), -jnp.inf, lg)
    return np.isfinite(np.asarray(lg))


def test_filter_logits_keeps_the_jax_sets():
    rs = np.random.RandomState(1)
    logits = (rs.randn(6, 50) * 3).astype(np.float32)
    t = np.asarray([1.0, 0.7, 1.3, 1.0, 0.0, 2.0], np.float32)
    k = np.asarray([0, 5, 1, 12, 3, 0], np.int64)
    p = np.asarray([0.0, 0.0, 0.5, 0.8, 0.9, 0.3], np.float32)
    ours = torch.isfinite(filter_logits(torch.from_numpy(logits),
                                        torch.from_numpy(t),
                                        torch.from_numpy(k),
                                        torch.from_numpy(p))).numpy()
    np.testing.assert_array_equal(ours, _jax_kept(logits, t, k, p))
    assert ours[2].sum() == 1 and ours[1].sum() == 5


def test_sample_tokens_greedy_and_top1_match_jax():
    from mxnet_tpu.serving.sampling import sample_tokens as jax_sample
    import jax
    rs = np.random.RandomState(2)
    logits = rs.randn(4, 64).astype(np.float32)
    t = np.asarray([0.0, 0.9, 0.0, 1.5], np.float32)
    k = np.asarray([0, 1, 7, 1], np.int32)
    p = np.zeros(4, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    theirs = np.asarray(jax_sample(jnp.asarray(logits), keys, t, k, p))
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    ours = sample_tokens(torch.from_numpy(logits), gens, torch.from_numpy(t),
                         torch.from_numpy(k.astype(np.int64)),
                         torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(ours, theirs)


def test_sample_tokens_draws_inside_the_kept_set_per_row_stream():
    rs = np.random.RandomState(3)
    logits = torch.from_numpy(rs.randn(2, 40).astype(np.float32))
    t = torch.tensor([1.0, 1.0])
    k = torch.tensor([4, 4])
    p = torch.tensor([0.0, 0.0])
    kept = torch.isfinite(filter_logits(logits, t, k, p))

    def draws(seed0, seed1, n=30):
        g = [torch.Generator().manual_seed(seed0),
             torch.Generator().manual_seed(seed1)]
        return torch.stack([sample_tokens(logits, g, t, k, p)
                            for _ in range(n)])
    a = draws(5, 6)
    assert all(bool(kept[r, a[:, r]].all()) for r in range(2))
    b = draws(5, 99)
    assert torch.equal(a[:, 0], b[:, 0])      # row 0's stream is its own
    assert len(set(a[:, 0].tolist())) > 1


# -- the server against the JAX server -----------------------------------------

def test_server_16_requests_match_jax_server(nets):
    """The mixed workload of tests/test_serving.py through both servers
    with the same weights: token-identical (margin rule above), every
    block released, one prefill per request."""
    jnet, tnet = nets
    kw = dict(batch_slots=4, max_len=64, block_size=8, max_prompt_len=12)
    js = JaxServer(jnet, **kw)
    ts = InferenceServer(tnet, device=CPU, **kw)
    jr = _submit_mixed(js, np.random.RandomState(12), 16)
    tr = _submit_mixed(ts, np.random.RandomState(12), 16)
    js.run()
    ts.run()
    for (p, a), (_, b) in zip(jr, tr):
        assert b.state == "finished" and b.status == "ok"
        assert b.finish_reason == "length"
        _assert_same_tokens(tnet, p, b.output_tokens, a.output_tokens)
    st = ts.stats()
    assert st["prefill_calls"] == 16 and st["finished"] == 16
    assert st["kv_used_blocks"] == 0
    assert st["tokens_generated"] == sum(len(r.output_tokens)
                                         for _, r in tr)
    ts.cache.check()


def test_prefill_logits_match_jax_server(nets):
    jnet, tnet = nets
    kw = dict(batch_slots=4, max_len=64, block_size=8, max_prompt_len=12)
    js = JaxServer(jnet, **kw)
    ts = InferenceServer(tnet, device=CPU, **kw)
    rs = np.random.RandomState(21)
    for T in (12, 3, 7, 1):
        p = rs.randint(0, 256, T).astype(np.int32)
        js.submit(p, max_new_tokens=4)
        ts.submit(p, max_new_tokens=4)
    assert js._admit() == ts._admit() == 4
    np.testing.assert_allclose(ts._last_logits.numpy(),
                               np.asarray(js._last_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ts.cache.block_tables,
                                  js.cache.block_tables)
    assert list(ts._pos) == list(js._pos)


def test_preemption_under_starved_pool_matches_jax(nets):
    """A pool for ~1.5 sequences: the youngest request is preempted,
    re-queued at the front and regenerated, token-identical to the JAX
    server under the same pressure."""
    jnet, tnet = nets
    kw = dict(batch_slots=2, max_len=32, block_size=8, max_prompt_len=12,
              num_blocks=6)
    js = JaxServer(jnet, **kw)
    ts = InferenceServer(tnet, device=CPU, **kw)
    rs = np.random.RandomState(18)
    prompts = [rs.randint(0, 256, 10).astype(np.int32) for _ in range(2)]
    jr = [js.submit(p, max_new_tokens=12) for p in prompts]
    tr = [ts.submit(p, max_new_tokens=12) for p in prompts]
    js.run()
    ts.run()
    assert ts.preemptions >= 1 and ts.preemptions == js.preemptions
    for p, a, b in zip(prompts, jr, tr):
        assert b.status == "ok" and len(b.output_tokens) == 12
        _assert_same_tokens(tnet, p, b.output_tokens, a.output_tokens)
        assert b.tokens_counted == 12      # regenerated tokens count once
    assert ts.tokens_generated == 24
    ts.cache.check()


def test_preemption_cascade_skips_evicted_slots(nets):
    """PR-6 review fix: three slots churning in a 6-block pool; an older
    slot's ensure() preempting a younger one later in the same pass must
    not allocate to the evicted slot."""
    jnet, tnet = nets
    kw = dict(batch_slots=3, max_len=16, block_size=4, max_prompt_len=4,
              num_blocks=7)
    ts = InferenceServer(tnet, device=CPU, **kw)
    js = JaxServer(jnet, **kw)
    rs = np.random.RandomState(20)
    prompts = [rs.randint(0, 256, 4).astype(np.int32) for _ in range(3)]
    tr = [ts.submit(p, max_new_tokens=8) for p in prompts]
    jr = [js.submit(p, max_new_tokens=8) for p in prompts]
    ts.run(max_ticks=1000)
    js.run(max_ticks=1000)
    for p, a, b in zip(prompts, jr, tr):
        assert b.status == "ok"
        _assert_same_tokens(tnet, p, b.output_tokens, a.output_tokens)
    ts.cache.check()


def test_sampled_requests_are_reproducible(nets):
    _, tnet = nets
    outs = []
    for _ in range(2):
        ts = InferenceServer(tnet, device=CPU, batch_slots=2, max_len=32,
                             block_size=8, max_prompt_len=8)
        r = ts.submit(np.arange(5), max_new_tokens=6, temperature=0.9,
                      top_k=20, top_p=0.9, seed=7)
        g = ts.submit(np.arange(5), max_new_tokens=6)
        ts.run()
        outs.append((r.output_tokens, g.output_tokens))
    assert outs[0] == outs[1]


# -- the scheduler's edges -------------------------------------------------------

def _server(tnet, **kw):
    args = dict(batch_slots=2, max_len=32, block_size=8, max_prompt_len=8,
                device=CPU)
    args.update(kw)
    return InferenceServer(tnet, **args)


def test_submit_validation(nets):
    _, tnet = nets
    s = _server(tnet, num_blocks=3)
    with pytest.raises(ValueError, match="empty"):
        s.submit([], 2)
    with pytest.raises(ValueError, match="max_prompt_len"):
        s.submit(np.arange(9), 2)
    with pytest.raises(ValueError, match="max_len"):
        s.submit(np.arange(8), 30)
    with pytest.raises(ValueError, match="KV blocks"):
        s.submit(np.arange(8), 12)
    with pytest.raises(ValueError, match="token ids"):
        s.submit([3, 256], 2)
    with pytest.raises(ValueError, match="multiple of block_size"):
        _server(tnet, max_len=30)
    with pytest.raises(ValueError, match="max_prompt_len"):
        _server(tnet, max_prompt_len=40)


def test_deadline_cancel_and_preemption_cap(nets):
    _, tnet = nets
    s = _server(tnet)
    late = s.submit(np.arange(4), 4, deadline_s=0.0)
    queued = s.submit(np.arange(4), 4)
    s.submit(np.arange(4), 4)
    s.submit(np.arange(4), 4)
    assert s.cancel(queued.id) and not s.cancel(queued.id)
    s.step()
    assert late.status == "timed_out" and queued.status == "cancelled"
    running = [r for r in s._slot_req if r is not None]
    assert len(running) == 2 and s.cancel(running[0].id)
    s.run()
    assert s.stats()["status_counts"] == {
        "ok": 1, "timed_out": 1, "preempted": 0, "rejected": 0,
        "cancelled": 2}

    rs = np.random.RandomState(18)
    s = _server(tnet, max_prompt_len=12, num_blocks=6, max_preemptions=0)
    a = s.submit(rs.randint(0, 256, 10), 12)
    b = s.submit(rs.randint(0, 256, 10), 12)
    s.run()
    assert {a.status, b.status} == {"ok", "preempted"}
    s.cache.check()


def test_drain_shutdown_and_watchdog(nets):
    _, tnet = nets
    s = _server(tnet)
    reqs = [s.submit(np.arange(3), 3) for _ in range(3)]
    s.drain(max_ticks=1)
    with pytest.raises(RuntimeError, match="draining"):
        s.submit(np.arange(3), 3)
    s.shutdown(drain=False)
    assert s.stats()["shutdown"]
    assert all(r.state == "finished" for r in reqs)
    assert {r.status for r in reqs} == {"rejected"}
    assert s.cache.num_used_blocks == 0

    s = _server(tnet, watchdog_ticks=3)
    s.submit(np.arange(3), 3)
    s.cache.can_alloc = lambda n: False       # admission wedged
    with pytest.raises(ServerStalledError):
        s.run(max_ticks=10)

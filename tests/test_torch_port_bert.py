"""BERT and the Transformer of the port on the CPU against the JAX
package, with weights carried across by name (`load_jax_params`) and
inputs from seeded numpy RNGs:

- the attention route BERT takes (full, key-padded by ragged lengths,
  T = 128) at head dims 64 (BERT-base) and 8 (`bert_tiny`): the plain
  versions and `FlashAttentionFunction`'s gradients against
  `flash_attention_raw` with the Pallas forward and backward in
  interpret mode;
- `bert_tiny` and `transformer_tiny` at fp32 with dropout off, with and
  without `valid_length` / `src_valid_len`, and a BERT of max_length 128
  at T = 128 with the interpret env vars set, so that JAX takes its
  Pallas flash and LayerNorm kernels;
- five `FusedTrainStep(n_model_inputs=3)` AdamW steps of each against
  JAX's: losses and final weights;
- `amp.convert_block` and a bf16 `bert_tiny` (and `transformer_tiny`)
  against JAX's bf16 net;
- the layers' own semantics (`Dense`'s tanh GELU, `Dropout`).

Tolerances. fp32: 1e-5 relative plus 1e-5 absolute on activations of
O(1) (XLA and PyTorch reassociate the matmuls' and the statistics'
sums), 2e-5 for attention gradients, whose dS terms cancel. Train
steps: losses to rtol 1e-5; weights after five AdamW steps at lr 1e-3
(which move them by up to 5e-3) to 5e-5 max-abs, and outside the key
projections' biases at most one element in 10,000 beyond 1e-6. Adam's
m / sqrt(v) turns fp32 reassociation in a near-zero gradient into an
O(lr) difference: the key projections' bias has a gradient of exactly
zero in exact arithmetic (adding one value to every key's score leaves
the softmax unchanged), so both packages step it by their own rounding
noise. Measured: BERT 5 of 88,002 other elements beyond 1e-6, the
largest 2.8e-5 (one element of layer 1's ffn1 weight); the Transformer
1 of 52,388.
bf16: as `test_torch_port_bf16.py` (twice the JAX bf16 net's own
distance from an fp32 copy of the same weights).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kernels import flash_attention as jfa
from mxnet_tpu.kernels import fused_norm as jfn
from mxnet_tpu.models.bert import BERTForPretraining as JaxBert
from mxnet_tpu.models.transformer import TransformerMT as JaxMT
from mxnet_tpu.parallel.data_parallel import FusedTrainStep as JaxStep

import jax
import jax.numpy as jnp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.models import get_model
from mxnet_tpu_torch.models._params import load_jax_params
from mxnet_tpu_torch.models.bert import BERTForPretraining
from mxnet_tpu_torch.models.transformer import TransformerMT
from mxnet_tpu_torch.parallel import FusedTrainStep

T_ = torch.from_numpy
CPU = "cpu"
TINY = dict(units=32, hidden_size=64, num_layers=2, num_heads=4)


def _close(ours, theirs, tol=1e-5):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32), rtol=tol,
                               atol=tol)


def _nd(a):
    return mx.nd.array(a, dtype=str(a.dtype))


def _jax_params(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _bert_pair(vocab, max_length, seed=0):
    """(JAX BERTForPretraining, the port's) with dropout off and one set
    of weights."""
    mx.random.seed(seed)
    jnet = JaxBert(vocab_size=vocab, max_length=max_length, dropout=0.0,
                   **TINY)
    jnet.initialize()
    z = np.zeros((1, 4), np.int32)
    jnet(_nd(z), _nd(z), _nd(np.array([4], np.int32)))   # materialize
    tnet = BERTForPretraining(vocab_size=vocab, max_length=max_length,
                              dropout=0.0, device=CPU, **TINY)
    load_jax_params(tnet, _jax_params(jnet))
    return jnet, tnet


def _mt_pair(seed=0):
    mx.random.seed(seed)
    jnet = JaxMT(100, 100, dropout=0.0, **TINY)
    jnet.initialize()
    z = np.zeros((1, 4), np.int32)
    jnet(_nd(z), _nd(z), _nd(np.array([4], np.int32)))
    tnet = TransformerMT(100, 100, dropout=0.0, device=CPU, **TINY)
    load_jax_params(tnet, _jax_params(jnet))
    return jnet, tnet


def _bert_batch(B, T, V, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(4, V, (B, T)).astype(np.int32)
    tok = (rs.rand(B, T) < 0.5).astype(np.int32)
    vlen = rs.randint(T // 2, T + 1, B).astype(np.int32)
    return ids, tok, vlen


# -- the attention route ------------------------------------------------------

@pytest.mark.parametrize("d", [64, 8])
def test_padded_full_attention_matches_pallas_interpret(d, monkeypatch):
    """Non-causal attention with ragged key lengths, H = K (no GQA):
    forward and the Function's dq, dk, dv against jax.grad of
    flash_attention_raw with its Pallas kernels in interpret mode."""
    monkeypatch.setenv("MXNET_TPU_FLASH_INTERPRET", "1")
    before = jfa.FALLBACK_COUNT
    rs = np.random.RandomState(d)
    B, T, H = 3, 128, 2
    q, k, v, dout = (rs.randn(B, T, H, d).astype(np.float32)
                     for _ in range(4))
    lengths = np.array([128, 77, 64], np.int32)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention_raw(
            a, b, c, causal=False, lengths=jnp.asarray(lengths)) * dout)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout = jfa.flash_attention_raw(jq, jk, jv, causal=False,
                                   lengths=jnp.asarray(lengths))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    assert jfa.FALLBACK_COUNT == before
    tq, tk, tv = (T_(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=False,
                              lengths=T_(lengths))
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
    _close(out, jout)
    (out * T_(dout)).sum().backward()
    for ours, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(ours, theirs, tol=2e-5)
    # keys past a row's length take no gradient
    assert float(tk.grad[1, 77:].abs().max()) == 0.0


# -- forward parity -----------------------------------------------------------

def test_bert_tiny_parameters_are_the_jax_nets():
    jnet, tnet = _bert_pair(128, 64)
    assert len(dict(tnet.named_parameters())) == 47
    assert set(dict(tnet.named_parameters())) == set(jnet.collect_params())
    net = get_model("bert_tiny", device=CPU)
    for name in ("bert.word_embed.weight",
                 "bert.layer0.attention.query_proj.weight",
                 "bert.layer0.norm1.gamma", "bert.layer0.ffn1.bias",
                 "mlm_decoder.weight", "nsp_classifier.bias"):
        assert name in dict(net.named_parameters())
    assert not net.training      # dropout off until train()


@pytest.mark.parametrize("with_len", [True, False])
def test_bert_tiny_forward_matches_jax(with_len):
    jnet, tnet = _bert_pair(128, 64)
    ids, tok, vlen = _bert_batch(3, 40, 128, 1)
    jargs = [_nd(ids), _nd(tok)] + ([_nd(vlen)] if with_len else [])
    jmlm, jnsp = jnet(*jargs)
    with torch.no_grad():
        targs = [T_(ids), T_(tok)] + ([T_(vlen)] if with_len else [])
        mlm, nsp = tnet(*targs)
    _close(mlm, jmlm.asnumpy())
    _close(nsp, jnsp.asnumpy())


@pytest.mark.parametrize("with_len", [True, False])
def test_transformer_tiny_forward_matches_jax(with_len):
    """Encoder self-attention with its (B, T, T) mask, causal decoder
    self-attention and cross-attention with T != S."""
    jnet = mx.models.get_model("transformer_tiny")
    mx.random.seed(0)
    jnet.initialize()
    rs = np.random.RandomState(2)
    src = rs.randint(0, 100, (2, 12)).astype(np.int32)
    tgt = rs.randint(0, 100, (2, 9)).astype(np.int32)
    vlen = np.array([12, 7], np.int32)
    jargs = [_nd(src), _nd(tgt)] + ([_nd(vlen)] if with_len else [])
    theirs = jnet(*jargs).asnumpy()
    tnet = get_model("transformer_tiny", device=CPU)
    load_jax_params(tnet, _jax_params(jnet))
    with torch.no_grad():
        ours = tnet(*[T_(src), T_(tgt)] + ([T_(vlen)] if with_len else []))
    _close(ours, theirs)


def test_bert_at_t128_matches_the_pallas_route(monkeypatch):
    """max_length 128 at T = 128: JAX takes its Pallas flash (T % 128 ==
    0) and LayerNorm kernels in interpret mode, the port its plain
    versions; no JAX fallback is counted."""
    for k in ("MXNET_TPU_FLASH_INTERPRET", "MXNET_TPU_NORM_INTERPRET"):
        monkeypatch.setenv(k, "1")
    before = (jfa.FALLBACK_COUNT, jfn.FALLBACK_COUNT)
    jnet, tnet = _bert_pair(128, 128)
    ids, tok, vlen = _bert_batch(2, 128, 128, 3)
    jmlm, jnsp = jnet(_nd(ids), _nd(tok), _nd(vlen))
    with torch.no_grad():
        mlm, nsp = tnet(T_(ids), T_(tok), T_(vlen))
    _close(mlm, jmlm.asnumpy())
    _close(nsp, jnsp.asnumpy())
    assert (jfa.FALLBACK_COUNT, jfn.FALLBACK_COUNT) == before


# -- train steps --------------------------------------------------------------

STEPS = 5
ADAMW = dict(learning_rate=1e-3, wd=0.01, multi_precision=True)


def _mlm_nsp_losses(V):
    """bench.py's BERT loss (masked MLM mean plus NSP mean) in both
    packages."""
    jce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tce = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def jloss(mlm, nsp, labels, mask, nsp_labels):
        per = jce(mlm.reshape(-1, V), labels.reshape(-1))
        m = mask.reshape(-1).astype("float32")
        l1 = (per * m).sum() / mx.nd.maximum(m.sum(), mx.nd.array([1.0]))
        return l1 + jce(nsp, nsp_labels).mean()

    def tloss(mlm, nsp, labels, mask, nsp_labels):
        per = tce(mlm.reshape(-1, V), labels.reshape(-1))
        m = mask.reshape(-1).float()
        l1 = (per * m).sum() / torch.clamp(m.sum(), min=1.0)
        return l1 + tce(nsp, nsp_labels).mean()
    return jloss, tloss


def _check_steps(jstep, tstep, jnet, tnet, jbatch, tbatch, start):
    jl = [float(jstep(*jbatch).asscalar()) for _ in range(STEPS)]
    tl = [float(tstep(*tbatch)) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    jstep.sync_to_params()
    theirs = _jax_params(jnet)
    beyond = total = 0
    for n, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[n], rtol=0,
                                   atol=5e-5, err_msg=n)
        if not n.endswith("key_proj.bias"):     # a zero gradient's noise
            beyond += int((np.abs(p.detach().numpy() - theirs[n])
                           > 1e-6).sum())
            total += p.numel()
    assert beyond <= total // 10000
    # the weights moved by far more than the tolerance
    assert max(float(np.abs(theirs[n] - start[n]).max())
               for n in start) > 50 * 5e-5
    assert not tnet.training     # the step restores the net's mode


def test_bert_train_steps_match_jax():
    """bert_tiny at vocab 1024 (the MLM loss on the fused CE route, NSP
    on log_softmax, as at BERT-base), B=4, T=64, ragged valid_length,
    15% MLM mask."""
    V, B, T = 1024, 4, 64
    jnet, tnet = _bert_pair(V, 64)
    start = _jax_params(jnet)
    jloss, tloss = _mlm_nsp_losses(V)
    jstep = JaxStep(jnet, jloss, mx.optimizer.AdamW(**ADAMW),
                    n_model_inputs=3)
    tstep = FusedTrainStep(tnet, tloss, mt.optimizer.AdamW(**ADAMW),
                           n_model_inputs=3)
    ids, tok, vlen = _bert_batch(B, T, V, 4)
    rs = np.random.RandomState(5)
    labels = rs.randint(4, V, (B, T)).astype(np.int32)
    mask = (rs.rand(B, T) < 0.15).astype(np.float32)
    nsp = rs.randint(0, 2, B).astype(np.int32)
    batch = (ids, tok, vlen, labels, mask, nsp)
    _check_steps(jstep, tstep, jnet, tnet, [_nd(a) for a in batch],
                 [T_(a) for a in batch], start)


def test_transformer_train_steps_match_jax():
    """TransformerMT(100, 100, units 32, hidden 64, 2 layers, 4 heads,
    dropout 0), built directly on the JAX side (its factories pin
    dropout 0.1); B=3, src T=12, tgt T=10, ragged src_valid_len."""
    jnet, tnet = _mt_pair()
    start = _jax_params(jnet)
    jce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    jstep = JaxStep(jnet, lambda lg, y: jce(lg.reshape(-1, 100),
                                            y.reshape(-1)),
                    mx.optimizer.AdamW(**ADAMW), n_model_inputs=3)
    tstep = FusedTrainStep(tnet, lambda lg, y: tce(lg.reshape(-1, 100),
                                                   y.reshape(-1)),
                           mt.optimizer.AdamW(**ADAMW), n_model_inputs=3)
    rs = np.random.RandomState(6)
    src = rs.randint(0, 100, (3, 12)).astype(np.int32)
    tgt = rs.randint(0, 100, (3, 11)).astype(np.int32)
    vlen = np.array([12, 5, 9], np.int32)
    batch = (src, tgt[:, :-1], vlen, tgt[:, 1:].copy())
    _check_steps(jstep, tstep, jnet, tnet, [_nd(a) for a in batch],
                 [T_(a) for a in batch], start)


# -- bf16 ---------------------------------------------------------------------

@pytest.mark.parametrize("model", ["bert", "transformer"])
def test_bf16_outputs_within_twice_jax_bf16_distance(model):
    """`convert_block` keeps gamma and beta fp32 and casts the rest; the
    port's bf16 outputs stand within 2x the JAX bf16 net's own distance
    from an fp32 copy, and as close to fp32 themselves. The Transformer's
    fp32 positional encodings make its activations fp32 in both."""
    jnet, tnet = _bert_pair(128, 64) if model == "bert" else _mt_pair()
    t32 = _bert_pair(128, 64)[1] if model == "bert" else _mt_pair()[1]
    mx.amp.convert_block(jnet, jnp.bfloat16)
    mt.amp.convert_block(tnet, torch.bfloat16)
    for n, p in tnet.named_parameters():
        keep = n.rsplit(".", 1)[-1] in ("gamma", "beta")
        assert p.dtype == (torch.float32 if keep else torch.bfloat16), n
    load_jax_params(tnet, _jax_params(jnet))
    with torch.no_grad():
        for a, b in zip(t32.parameters(), tnet.parameters()):
            a.copy_(b.float())
    rs = np.random.RandomState(8)
    if model == "bert":
        ids, tok, vlen = _bert_batch(3, 40, 128, 8)
        args = (ids, tok, vlen)
    else:
        args = (rs.randint(0, 100, (2, 12)).astype(np.int32),
                rs.randint(0, 100, (2, 9)).astype(np.int32),
                np.array([12, 7], np.int32))
    theirs = jnet(*map(_nd, args))
    theirs = [o.asnumpy().astype(np.float32) for o in (
        theirs if isinstance(theirs, tuple) else (theirs,))]
    with torch.no_grad():
        ours = tnet(*map(T_, args))
        truth = t32(*map(T_, args))
    ours = ours if isinstance(ours, tuple) else (ours,)
    truth = truth if isinstance(truth, tuple) else (truth,)
    for o, j, t in zip(ours, theirs, truth):
        t = t.numpy()
        tol = 2.0 * float(np.abs(j - t).max())
        assert tol > 0
        o = o.float().numpy()
        assert float(np.abs(o - j).max()) <= tol
        assert float(np.abs(o - t).max()) <= tol


# -- layers -------------------------------------------------------------------

def test_dense_gelu_is_the_tanh_form():
    """`Dense(activation="gelu")` is jax.nn.gelu's default tanh form: it
    matches the JAX layer to 1e-6, and the exact erf form does not."""
    rs = np.random.RandomState(9)
    x = (3 * rs.randn(6, 16)).astype(np.float32)
    jd = mx.gluon.nn.Dense(8, activation="gelu", in_units=16)
    jd.initialize()
    theirs = jd(mx.nd.array(x)).asnumpy()
    td = mt.gluon.nn.Dense(8, 16, activation="gelu")
    mt.gluon.nn.initialize(td, CPU)
    load_jax_params(td, _jax_params(jd))
    with torch.no_grad():
        ours = td(T_(x))
        pre = torch.nn.functional.linear(T_(x), td.weight, td.bias)
        exact = torch.nn.functional.gelu(pre)
    _close(ours, theirs, tol=1e-6)
    assert float(np.abs(exact.numpy() - theirs).max()) > 1e-4


def test_dropout_draws_from_the_callers_generator():
    """Inverted dropout in training mode only, from the given generator:
    a reseeded generator gives the same mask, kept elements are scaled
    by 1 / (1 - rate), and a bf16 input draws the fp32 input's mask."""
    gen = torch.Generator().manual_seed(3)
    drop = mt.gluon.nn.Dropout(0.25, gen)
    x = torch.ones(64, 64)
    assert drop.eval()(x) is x
    drop.train()
    a = drop(x)
    gen.manual_seed(3)
    b = drop(x.bfloat16())
    assert b.dtype == torch.bfloat16
    kept = a != 0
    assert torch.equal(kept, b != 0)
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert 0.65 < float(kept.float().mean()) < 0.85
    with pytest.raises(RuntimeError, match="torch.Generator"):
        mt.gluon.nn.Dropout(0.1).train()(x)


def test_train_step_runs_dropout_with_the_generator():
    """With dropout on, the step draws from the net's generator: two
    nets from one seed and generators reseeded alike give equal losses,
    and the loss differs from the eval-mode forward's."""
    ids, tok, vlen = _bert_batch(2, 16, 128, 10)
    lbl = np.random.RandomState(11).randint(0, 128, (2, 16))
    losses = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        net = get_model("bert_tiny", device=CPU, dropout_generator=gen)
        ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        step = FusedTrainStep(
            net, lambda mlm, nsp, y: ce(mlm.reshape(-1, 128), y.reshape(-1)),
            mt.optimizer.AdamW(**ADAMW), n_model_inputs=3)
        losses.append(float(step.loss_of(*map(T_, (ids, tok, vlen, lbl)))
                            .detach()))
    assert losses[0] == losses[1]
    with torch.no_grad():
        mlm, _ = net(T_(ids), T_(tok), T_(vlen))
        plain = float(ce(mlm.reshape(-1, 128), T_(lbl).reshape(-1)).mean())
    assert abs(plain - losses[0]) > 1e-4

"""The port's training step on the CPU against the JAX package: five
`FusedTrainStep` steps of a small Llama (vocab 1024, hidden 64, 2
layers, 4 / 2 heads, fp32) at B=2, T=128 through both packages from the
same weights (`load_jax_params`) and the same batch, with SGD (momentum),
Adam and AdamW, on the JAX package's jnp route and with its three Pallas
kernel families in interpret mode (the port takes its plain versions on
the CPU either way). V = 1024 and T % 128 == 0 engage the fused CE and
the Pallas flash route, as the full-width step does.

Losses agree to rtol 1e-5. Weights: SGD to 1e-6 max-abs (measured
6e-8). Adam and AdamW to 1e-5 on the jnp route (measured up to 3.5e-6)
and 2e-5 on the interpret route, where the measured gap is 9.5e-6: one
element of layer 1's q_proj, every other element within 1e-6 (Adam's
m / sqrt(v) turns fp32 reassociation in a near-zero gradient into an
O(lr) difference). Then the loss block's log_softmax route below the
fused gate, and what the step refuses.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kernels import flash_attention as jfa
from mxnet_tpu.kernels import fused_ce as jce
from mxnet_tpu.kernels import fused_norm as jfn
from mxnet_tpu.models.llama import LlamaConfig as JaxConfig
from mxnet_tpu.models.llama import LlamaForCausalLM as JaxLlama
from mxnet_tpu.parallel.data_parallel import FusedTrainStep as JaxStep

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          load_jax_params)
from mxnet_tpu_torch.parallel import FusedTrainStep

V, B, T, STEPS = 1024, 2, 128, 5
CFG = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
           num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=T,
           dtype="float32")
INTERPRET = ("MXNET_TPU_FLASH_INTERPRET", "MXNET_TPU_NORM_INTERPRET",
             "MXNET_TPU_CE_INTERPRET")
#: (optimizer name, keyword arguments) shared by both packages
OPTIMIZERS = {"sgd": ("SGD", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
              "adam": ("Adam", dict(learning_rate=1e-3, wd=0.01)),
              "adamw": ("AdamW", dict(learning_rate=3e-4, wd=0.1))}
#: weight tolerance (max-abs) per optimizer and route, see the docstring
WEIGHT_ATOL = {("sgd", "jnp"): 1e-6, ("sgd", "interpret"): 1e-6,
               ("adam", "jnp"): 1e-5, ("adam", "interpret"): 2e-5,
               ("adamw", "jnp"): 1e-5, ("adamw", "interpret"): 2e-5}


def _nets():
    mx.random.seed(0)
    jnet = JaxLlama(JaxConfig(**CFG))
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))   # materialize
    start = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_jax_params(tnet, start)
    return jnet, tnet, start


@pytest.mark.parametrize("route", ["jnp", "interpret"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_fused_train_step_matches_jax(opt, route, monkeypatch):
    if route == "interpret":
        for k in INTERPRET:
            monkeypatch.setenv(k, "1")
    fallbacks = [m.FALLBACK_COUNT for m in (jfa, jfn, jce)]
    jnet, tnet, start = _nets()
    name, kw = OPTIMIZERS[opt]
    jce_ = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tce_ = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    jstep = JaxStep(jnet, lambda lg, y: jce_(lg.reshape(-1, V),
                                              y.reshape(-1)),
                    getattr(mx.optimizer, name)(**kw))
    tstep = FusedTrainStep(tnet, lambda lg, y: tce_(lg.reshape(-1, V),
                                                    y.reshape(-1)),
                           getattr(mt.optimizer, name)(**kw))
    tok = np.random.RandomState(0).randint(0, V, (B, T + 1))
    x, y = tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)
    jl = [float(jstep(mx.nd.array(x, dtype="int32"),
                      mx.nd.array(y, dtype="int32")).asscalar())
          for _ in range(STEPS)]
    tl = [float(tstep(torch.from_numpy(x).long(), torch.from_numpy(y)))
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    jstep.sync_to_params()
    tstep.sync_to_params()
    theirs = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    atol = WEIGHT_ATOL[opt, route]
    for n, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[n], rtol=0,
                                   atol=atol, err_msg=n)
    # the weights moved by far more than the tolerance
    assert max(float(np.abs(theirs[n] - start[n]).max())
               for n in start) > 50 * atol
    assert [m.FALLBACK_COUNT for m in (jfa, jfn, jce)] == fallbacks


def test_train_step_goes_through_the_functions(monkeypatch):
    """On the step's path every norm, attention and the loss run through
    their autograd Functions: 2L + 1 norms, L attentions, one CE."""
    from mxnet_tpu_torch.kernels import flash_attention, fused_ce, fused_norm
    seen = {"norm": 0, "attn": 0, "ce": 0}
    for mod, cls, key in ((fused_norm, "RMSNormFunction", "norm"),
                          (flash_attention, "FlashAttentionFunction", "attn"),
                          (fused_ce, "SoftmaxCEFunction", "ce")):
        orig = getattr(mod, cls).forward

        def counted(ctx, *a, _orig=orig, _key=key):
            seen[_key] += 1
            return _orig(ctx, *a)
        monkeypatch.setattr(getattr(mod, cls), "forward",
                            staticmethod(counted))
    _, tnet, _ = _nets()
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    step = FusedTrainStep(tnet, lambda lg, y: ce(lg.reshape(-1, V),
                                                 y.reshape(-1)),
                          mt.optimizer.AdamW(learning_rate=3e-4, wd=0.1))
    tok = np.random.RandomState(1).randint(0, V, (B, T + 1))
    loss = step(tok[:, :-1], tok[:, 1:])
    L = CFG["num_layers"]
    assert seen == {"norm": 2 * L + 1, "attn": L, "ce": 1}
    assert loss.dtype == torch.float32 and loss.dim() == 0
    # AdamW's two fp32 moments per parameter, no fp32 master copy
    assert [tuple(m.shape) for m, _ in step._states] == \
        [tuple(p.shape) for p in tnet.parameters()]


@pytest.mark.parametrize("vocab", [256, 1023])
def test_softmax_ce_loss_below_the_gate_matches_jax(vocab, monkeypatch):
    """Below the 1024 gate the loss takes log_softmax and a pick, the
    JAX package's own route: values and the logits' gradient match, with
    sample weights and a (B, T, V) input averaged per sample."""
    from mxnet_tpu_torch.kernels import fused_ce
    monkeypatch.setattr(fused_ce, "softmax_ce", None)   # never called
    rs = np.random.RandomState(vocab)
    pred = rs.randn(3, 5, vocab).astype(np.float32)
    lbl = rs.randint(0, vocab, (3, 5)).astype(np.int32)
    sw = rs.rand(3, 5, 1).astype(np.float32)
    jl = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    jp = mx.nd.array(pred)
    jp.attach_grad()
    with mx.autograd.record():
        out = jl(jp, mx.nd.array(lbl, dtype="int32"), mx.nd.array(sw))
    out.backward()
    tp = torch.from_numpy(pred).requires_grad_()
    ours = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
        tp, torch.from_numpy(lbl).long(), torch.from_numpy(sw))
    assert ours.shape == (3,)
    np.testing.assert_allclose(ours.detach().numpy(), out.asnumpy(),
                               rtol=1e-5, atol=1e-6)
    ours.sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), jp.grad.asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_softmax_ce_loss_fused_route_matches_jax():
    """At V >= 1024 the loss takes the fused route (per-row loss, then
    (N, 1), weighting and the mean), equal to the JAX loss's value."""
    rs = np.random.RandomState(3)
    pred = rs.randn(6, 2048).astype(np.float32)
    lbl = rs.randint(0, 2048, 6).astype(np.int32)
    theirs = mx.gluon.loss.SoftmaxCrossEntropyLoss(weight=0.5)(
        mx.nd.array(pred), mx.nd.array(lbl, dtype="int32")).asnumpy()
    ours = mt.gluon.loss.SoftmaxCrossEntropyLoss(weight=0.5)(
        torch.from_numpy(pred), torch.from_numpy(lbl))
    assert ours.shape == (6,)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-6)


def test_step_refuses_unported_modes_and_rules():
    _, tnet, _ = _nets()
    opt = mt.optimizer.SGD(learning_rate=0.1)
    for kw in (dict(grad_accum=2), dict(mesh=object()), dict(zero=1),
               dict(zero1=True), dict(compression={"type": "2bit"}),
               dict(pipeline=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A1"):
            FusedTrainStep(tnet, lambda lg, y: lg.sum(), opt, **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        mt.optimizer.create("lamb")
    assert isinstance(mt.optimizer.create("adamw"), mt.optimizer.AdamW)

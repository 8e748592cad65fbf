"""The one-device fused training step (counterpart of
`mxnet_tpu/parallel/data_parallel.FusedTrainStep`).

    net = get_model("llama_3_8b", num_layers=4)      # on cuda
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    step = FusedTrainStep(net, lambda lg, y: ce(lg.reshape(-1, V),
                                                y.reshape(-1)),
                          optimizer.AdamW(learning_rate=3e-4, wd=0.1))
    loss = step(x, y)            # forward, loss, backward, update

One call runs the net's forward, in training mode (dropout active), on
the first `n_model_inputs` arguments (the model inputs); the loss on its
output and the remaining arguments (labels), a tuple output splatted
into `loss_fn(*outputs, *labels)` as the JAX step does (BERT's MLM and
NSP logits); `.mean()` in fp32; the backward; and the optimizer's
`_step` on every parameter that requires a gradient, with the JAX step's
hyperparameters: `lr` the optimizer's learning rate, `wd` its weight
decay for every parameter, `t` the step count, `rescale` its gradient
rescale. The net's own mode is restored after the forward. The JAX package
compiles all of that into one XLA program; PyTorch runs it eagerly, the
kernels of the forward and backward being the port's own. Weights are
updated in place in the net's parameters, so `sync_to_params` has
nothing to write back. Optimizer states come from `create_state`, with
no fp32 master copy of a bf16 weight (data_parallel.py:383 there), so an
optimizer's `multi_precision=True` changes nothing here.

Not ported yet: a mesh and every multi-device mode (ZeRO, compression,
pipelines; ROADMAP A16) and gradient accumulation (ROADMAP A10, second
part); each raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FusedTrainStep"]


class FusedTrainStep:
    """Forward, loss, backward and update of `net` in one call."""

    def __init__(self, net, loss_fn, trainer, mesh=None, grad_accum=1,
                 compression=None, zero1=False, zero=None, pipeline=None,
                 n_model_inputs=1):
        unported = {"mesh": mesh is not None,
                    "compression": bool(compression),
                    "zero1": bool(zero1),
                    "zero": zero not in (None, False, 0),
                    "pipeline": pipeline is not None}
        for name, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"FusedTrainStep({name}=...) is not ported: the port "
                    f"runs one device (ROADMAP A16)")
        if grad_accum != 1:
            raise NotImplementedError(
                "FusedTrainStep(grad_accum > 1) is not ported yet (ROADMAP "
                "A10, second part)")
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = trainer
        self.n_model_inputs = n_model_inputs
        self._step_count = 0
        self._params = None
        self._states = None

    def _init_state(self):
        self._params = [p for p in self.net.parameters() if p.requires_grad]
        self._states = [self.optimizer.create_state(i, p.detach())
                        for i, p in enumerate(self._params)]

    def _hyper(self):
        def f32(x):
            return torch.tensor(x, dtype=torch.float32)
        opt = self.optimizer
        return {"lr": f32(opt.learning_rate), "wd": f32(opt.wd),
                "t": torch.tensor(self._step_count, dtype=torch.int32),
                "rescale": f32(opt.rescale_grad)}

    def _as_tensor(self, a):
        dev = self._params[0].device
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.as_tensor(np.asarray(a), device=dev)

    def loss_of(self, *args):
        """The step's scalar fp32 loss of one batch (model inputs, then
        labels), graph attached; the forward runs in training mode."""
        n = self.n_model_inputs
        was_training = self.net.training
        self.net.train()
        try:
            outs = self.net(*args[:n])
        finally:
            self.net.train(was_training)
        if not isinstance(outs, tuple):
            outs = (outs,)
        loss = self.loss_fn(*outs, *args[n:])
        return loss.mean().to(torch.float32)

    def loss_and_grads(self, *args):
        """(detached loss, gradients in parameter order) of one batch:
        the forward and backward half of a step, weights untouched."""
        if self._params is None:
            self._init_state()
        args = [self._as_tensor(a) for a in args]
        with torch.enable_grad():
            loss = self.loss_of(*args)
            grads = torch.autograd.grad(loss, self._params)
        return loss.detach(), grads

    def apply_update(self, grads):
        """The update half of a step: count it, then `_step` every
        parameter with its gradient, in place."""
        self._step_count += 1
        hyper = self._hyper()
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(self._params, grads)):
                new_w, self._states[i] = self.optimizer._step(
                    p, g, self._states[i], hyper)
                p.copy_(new_w)

    def __call__(self, *args):
        loss, grads = self.loss_and_grads(*args)
        self.apply_update(grads)
        return loss

    def sync_to_params(self):
        """The step updates the net's parameters in place: nothing to
        write back (kept for the JAX package's call pattern)."""

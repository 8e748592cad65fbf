"""mxnet_tpu_torch — the PyTorch/CUDA port of `mxnet_tpu`, for NVIDIA
Hopper (H100).

The JAX package stays the reference; this package imports neither it nor
JAX. Plain tensor code is PyTorch, and every TPU kernel on a ported path
is a hand-written CUDA kernel (`kernels/`, sources in `csrc/`, built with
nvcc for sm_90a at first use). Entry points run on `cuda` unless the
caller passes `device="cpu"`; on the CPU each kernel wrapper takes its
plain PyTorch version.

Ported so far: the Llama serving path — `models.get_model("llama_3_8b")`
and `serving.InferenceServer` (paged prefill + decode tick, bf16 or int8
KV pool) — and contiguous-cache generation, `models.generate` and
`models.generate_beam` (bf16 or int8 cache), with the RMSNorm,
flash-prefill and four decode-attention kernels (contiguous and paged,
each over a model-dtype or an int8 cache); the prefix cache, chunked
prefill and speculative verify on the paged server, with the window
attention kernel; and the Llama training step,
`parallel.FusedTrainStep` with `gluon.loss.SoftmaxCrossEntropyLoss` and
`optimizer.SGD`/`Adam`/`AdamW`, with the RMSNorm backward, the flash
attention backward (dQ, dK/dV) and the fused softmax cross-entropy
kernels.
"""
from . import gluon, models, optimizer, parallel, serving
from .context import resolve_device

__all__ = ["gluon", "models", "optimizer", "parallel", "serving",
           "resolve_device"]

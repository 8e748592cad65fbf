"""Continuous-batching inference serving (counterpart of
`mxnet_tpu.serving`).

- `kv_cache.PagedKVCache` — block-allocated KV pool with per-sequence
  block tables; sequences of different lengths share one decode batch.
- `executables` — the prefill and the decode tick over that pool, and
  the contiguous-cache prefill, step and step loop of `generate()`, with
  call counts.
- `server.InferenceServer` — admit into free batch slots and evict
  finished sequences every decode tick, per-request sampling params.

    server = InferenceServer(net, batch_slots=8, max_len=256,
                             kv_cache_dtype="int8")   # or "model"
    reqs = [server.submit(p, max_new_tokens=32, temperature=0.8, seed=1)
            for p in prompts]
    server.run()
"""
from .kv_cache import PagedKVCache
from .sampling import filter_logits, sample_tokens
from .server import InferenceServer, Request, ServerStalledError

__all__ = ["PagedKVCache", "InferenceServer", "Request",
           "ServerStalledError", "sample_tokens", "filter_logits"]

"""Parameter plumbing for Llama inference (counterpart of
`mxnet_tpu/models/llama_infer.py`; its `generate()` is not ported yet)."""
from __future__ import annotations

__all__ = ["_params_tree"]


def _params_tree(net):
    """The decoder weights as a plain dict keyed by role. The tensors are
    the module's own (detached views), so later weight loads show
    through without a refresh."""
    cfg = net.model.cfg
    ps = {n: p.detach() for n, p in net.named_parameters()}
    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        layers.append({
            "ln1": ps[pre + "input_layernorm.gamma"],
            "wq": ps[pre + "self_attn.q_proj.weight"],
            "wk": ps[pre + "self_attn.k_proj.weight"],
            "wv": ps[pre + "self_attn.v_proj.weight"],
            "wo": ps[pre + "self_attn.o_proj.weight"],
            "ln2": ps[pre + "post_attention_layernorm.gamma"],
            "gate": ps[pre + "mlp.gate_proj.weight"],
            "up": ps[pre + "mlp.up_proj.weight"],
            "down": ps[pre + "mlp.down_proj.weight"],
        })
    return {"embed": ps["model.embed_tokens.weight"],
            "norm": ps["model.norm.gamma"],
            "head": ps["lm_head.weight"],
            "layers": layers}

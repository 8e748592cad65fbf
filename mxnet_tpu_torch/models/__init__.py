"""Model zoo of the port (counterpart of `mxnet_tpu/models`): the Llama
family, with contiguous-cache `generate` and `generate_beam`
(`llama_infer`); BERT (`bert_base`, `bert_large`, `bert_tiny`) and the
Transformer (`transformer_base`, `transformer_tiny`)."""
from __future__ import annotations

from .llama_infer import generate, generate_beam

_FACTORIES = {}


def register_model(name):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn
    return deco


def _ensure_registry():
    from . import bert, llama, transformer  # noqa: F401
    return _FACTORIES


def list_models():
    return sorted(_ensure_registry())


def get_model(name, **kwargs):
    """Build a registered model; keyword arguments go to its factory
    (`device=` places the weights, default `cuda`)."""
    name = name.lower()
    _ensure_registry()
    if name not in _FACTORIES:
        raise ValueError(f"unknown model {name}; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)

"""The one place the benchmark touches the system under test, the port
``repro_torch`` in the checkout's ``src/``: its configuration type, its
model built around the benchmark's weights, and the counters it keeps.

Nothing here is imported until a run has found its card, and nothing of
``repro_torch`` is imported by :mod:`cardbench.reference`.
"""

from __future__ import annotations

import importlib

import torch

__all__ = ["port", "model_config", "port_name", "build_model",
           "flash_launches"]

#: which of a block's matrices live in its attention and which in its MLP
_MODULE_OF = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
              "w1": "mlp", "w3": "mlp", "w2": "mlp"}
#: the configuration file's keys that the port's ModelConfig takes
_MODEL_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
               "head_dim", "d_ff", "vocab_size", "norm", "rope_theta",
               "tied_embeddings", "dtype", "attention_impl", "remat")


def port(name: str):
    """``repro_torch.<name>``, imported at first use."""
    return importlib.import_module(f"repro_torch.{name}")


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    return port("configs").ModelConfig(name=cfg["name"],
                                       **{k: cfg[k] for k in _MODEL_KEYS})


def port_name(name: str) -> str:
    """The port's parameter name of a weight the benchmark names as
    :func:`cardbench.reference.train.leaves` does."""
    parts = name.split(".")
    if len(parts) == 3 and parts[0] == "layers" and parts[2] in _MODULE_OF:
        return f"layers.{parts[1]}.{_MODULE_OF[parts[2]]}.{parts[2]}"
    return name


def build_model(cfg: dict, leaves: dict):
    """The port's model for ``cfg`` holding ``leaves`` (the benchmark's
    weights by name) as its parameters, not copies: built on the meta
    device, then given the tensors."""
    models = port("models")
    model = models.init_params(model_config(cfg), torch.Generator(),
                               device="meta")
    model.load_state_dict({port_name(n): t for n, t in leaves.items()},
                          strict=True, assign=True)
    return model


def flash_launches() -> int:
    """The flash-attention kernel launches the port has counted."""
    return port("kernels.flash_attention.ops").counts["flash_attention"]

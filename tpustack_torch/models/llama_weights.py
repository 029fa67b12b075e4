"""Llama / Qwen2 weights for the port: the JAX parameter tree carried across,
or a seeded random initialisation drawn as the flax initialisers draw.

The port's modules carry the JAX model's names with the checkpoint layout
(``layers.{i}.self_attn.q_proj.weight`` ...), so a flax path maps onto its
key by the rule of ``tpustack/models/llama_weights.py``: ``layers_{i}`` ->
``layers.{i}``, ``kernel``/``scale``/``embedding`` -> ``weight``/``scale``/
``weight``, and a dense kernel ``[in, out]`` is transposed to a torch Linear
``[out, in]``.  Loading is ``load_state_dict(strict=True)``.  A weight-only
int8 tree (``tpustack.ops.quant.quantize_params``: ``{kernel [in, out]
int8, scale [out]}`` per projection, ``{embedding int8, scale}`` for the
table) maps the same way, its int8 leaves kept int8 (a transpose, no
requantisation).

Loading a Hugging Face checkpoint (``MODEL_DIR``) needs a safetensors reader
the port does not have yet.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tpustack_torch.models.llama import LlamaModel

_LEAF = {"kernel": "weight", "scale": "scale", "bias": "bias", "embedding": "weight"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_path_to_key(path: Tuple[str, ...]) -> str:
    """``('layers_3', 'self_attn', 'q_proj', 'kernel')`` ->
    ``'layers.3.self_attn.q_proj.weight'``."""
    body = [f"layers.{m[1]}" if (m := re.fullmatch(r"layers_(\d+)", p)) else p
            for p in path[:-1]]
    return ".".join(body + [_LEAF[path[-1]]])


def params_from_jax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``Generator.params`` tree (numpy or jax arrays) -> a state
    dict for :class:`LlamaModel`: float leaves as float32, int8 leaves (a
    quantised tree) as int8."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(flax_params):
        key = jax_path_to_key(path)
        if key in out:
            raise ValueError(f"duplicate key {key!r} (from {'/'.join(path)})")
        w = np.asarray(leaf)
        w = w if w.dtype == np.int8 else w.astype(np.float32)
        out[key] = torch.tensor(np.ascontiguousarray(w.T if path[-1] == "kernel" else w))
    return out


def load_params(model: LlamaModel, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Strict load into ``model``'s own dtype and device (a missing,
    unexpected or mis-shaped key raises)."""
    own = model.state_dict()
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in state_dict.items()
           if k in own and tuple(v.shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"{len(bad)} shape mismatches (first 10): {bad[:10]}")
    model.load_state_dict({k: v.to(own[k].dtype) if k in own else v
                           for k, v in state_dict.items()}, strict=True)


@torch.no_grad()
def init_random_(model: LlamaModel, seed: int = 0) -> LlamaModel:
    """Fill ``model`` in place, on its own device and in its own dtype, from
    ``seed``: the flax initialisers' distributions (their numbers differ).

    - dense kernels: lecun normal, a normal of std ``sqrt(1/fan_in) /
      0.8796`` truncated at two of its std (``nn.Dense``'s default);
    - biases zero; RMSNorm scales one;
    - the embedding: normal of std ``sqrt(1/vocab)`` (``nn.Embed``'s
      ``variance_scaling(1, 'fan_in', 'normal', out_axis=0)``).

    Each tensor is drawn in float32 on the device and copied into the
    parameter, so a bf16 model on the card never holds a float32 copy of
    more than one tensor."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif name == "embed_tokens.weight":
            tmp = torch.empty(p.shape, dtype=torch.float32, device=dev)
            p.copy_(tmp.normal_(0.0, math.sqrt(1.0 / p.shape[0]), generator=gen))
        else:  # Linear weight [out, in]: fan_in is the input width
            std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
            tmp = torch.empty(p.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std, generator=gen)
            p.copy_(tmp)
    return model

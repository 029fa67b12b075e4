"""SD1.5 weights: JAX parameter trees -> the port's ``state_dict``s.

The port's modules carry the diffusers / transformers names, so a tree from
the JAX package maps onto them by that package's own rule: each flax path
becomes its checkpoint key, and each leaf its torch layout.  This module is
the port's copy of ``our_path_to_hf_key`` and the layout transforms of
``tpustack/models/sd15/weights.py``:

- flax NHWC conv kernel ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``
- flax dense kernel ``[I, O]``               -> torch Linear ``[O, I]``
- {Group,Layer}Norm scale/bias, embeddings   -> weight/bias, as they are

Loading is strict: :func:`load_into` raises on a missing, unexpected or
mis-shaped key.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Tree = Mapping[str, Any]
TOWERS = ("text_encoder", "unet", "vae_decoder")

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
# our CLIP position_embedding is a raw flax param (no submodule)
_CLIP_POS_KEY = "text_model.embeddings.position_embedding.weight"


def conv_to_torch(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def linear_to_torch(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unet_prefix(parts: Tuple[str, ...], n_levels: int) -> Tuple[str, ...]:
    """Our UNet module path head -> the diffusers module path head."""
    head, rest = parts[0], parts[1:]
    for pat, fmt in ((r"down_(\d+)_res_(\d+)", "down_blocks.{}.resnets.{}"),
                     (r"down_(\d+)_attn_(\d+)", "down_blocks.{}.attentions.{}"),
                     (r"down_(\d+)_downsample", "down_blocks.{}.downsamplers.0")):
        m = re.fullmatch(pat, head)
        if m:
            return (fmt.format(*m.groups()),) + rest
    for pat, fmt in ((r"up_(\d+)_res_(\d+)", "up_blocks.{}.resnets.{}"),
                     (r"up_(\d+)_attn_(\d+)", "up_blocks.{}.attentions.{}"),
                     (r"up_(\d+)_upsample", "up_blocks.{}.upsamplers.0")):
        m = re.fullmatch(pat, head)
        if m:  # our level L is diffusers' up_blocks index n_levels - 1 - L
            return (fmt.format(n_levels - 1 - int(m[1]), *m.groups()[1:]),) + rest
    return {
        "time_fc1": ("time_embedding.linear_1",) + rest,
        "time_fc2": ("time_embedding.linear_2",) + rest,
        "mid_res_0": ("mid_block.resnets.0",) + rest,
        "mid_res_1": ("mid_block.resnets.1",) + rest,
        "mid_attn": ("mid_block.attentions.0",) + rest,
        "norm_out": ("conv_norm_out",) + rest,
    }.get(head, parts)


def _transformer_inner(parts: Tuple[str, ...]) -> Tuple[str, ...]:
    """Inside a Transformer2D: blocks_k -> transformer_blocks.k, ff/attn naming."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        m = re.fullmatch(r"blocks_(\d+)", p)
        if m:
            out.append(f"transformer_blocks.{m[1]}")
        elif p == "ff":
            out.append("ff.net.0.proj" if parts[i + 1] == "proj_in" else "ff.net.2")
            i += 1  # consumed proj_in/proj_out
        elif p == "to_out":
            out.append("to_out.0")
        else:
            out.append(p)
        i += 1
    return tuple(out)


_VAE_NAMES = {"mid": "mid_block", "res_0": "resnets.0", "res_1": "resnets.1",
              "attn": "attentions.0", "norm": "group_norm", "to_out": "to_out.0",
              "norm_out": "conv_norm_out"}


def jax_path_to_key(parts: Tuple[str, ...], model: str, n_levels: int = 4) -> str:
    """A flax param path (tuple of names) -> the port's ``state_dict`` key."""
    parts = tuple(parts)
    if model == "text_encoder" and parts == ("position_embedding",):
        return _CLIP_POS_KEY
    leaf, body = parts[-1], parts[:-1]
    if model == "unet":
        body = _transformer_inner(_unet_prefix(body, n_levels))
    elif model == "text_encoder":
        body = tuple(f"encoder.layers.{m[1]}" if (m := re.fullmatch(r"layers_(\d+)", p))
                     else p for p in body)
        if body and body[0] == "token_embedding":
            body = ("embeddings",) + body
        body = ("text_model",) + body
    elif model == "vae_decoder":
        mapped = []
        for p in body:
            m = re.fullmatch(r"up_(\d+)_res_(\d+)", p)
            if m:
                mapped.append(f"up_blocks.{m[1]}.resnets.{m[2]}")
                continue
            m = re.fullmatch(r"up_(\d+)_upsample", p)
            if m:
                mapped.append(f"up_blocks.{m[1]}.upsamplers.0.conv")
                continue
            mapped.append(_VAE_NAMES.get(p, p))
        body = tuple(mapped)
        # post_quant_conv sits at the AutoencoderKL top level, not under decoder
        if body[0] != "post_quant_conv":
            body = ("decoder",) + body
    else:
        raise ValueError(f"unknown model {model}")
    return ".".join(body + (_LEAF[leaf],))


def _n_levels(unet_tree: Tree) -> int:
    levels = [int(m[1]) for k in unet_tree if (m := re.fullmatch(r"down_(\d+)_res_\d+", k))]
    return max(levels) + 1


def tower_from_jax(tree: Tree, model: str, n_levels: int = 4) -> Dict[str, torch.Tensor]:
    """One tower's flax tree (numpy leaves) -> a float32 ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree).items():
        key = jax_path_to_key(path, model, n_levels)
        if key in out:
            raise ValueError(f"duplicate key {key!r} (from {'/'.join(path)})")
        w = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            w = conv_to_torch(w) if w.ndim == 4 else linear_to_torch(w)
        out[key] = torch.from_numpy(np.ascontiguousarray(w))
    return out


def params_from_jax(tree: Tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX pipeline's parameter tree (``{"text_encoder", "unet",
    "vae_decoder", ...}`` of nested dicts of numpy arrays) -> ``{tower:
    state_dict}`` for the port's text encoder, UNet and VAE decoder.  Other
    towers (the VAE encoder) are not on this path and are ignored."""
    missing = [t for t in TOWERS if t not in tree]
    if missing:
        raise ValueError(f"parameter tree lacks {missing}")
    n = _n_levels(tree["unet"])
    return {t: tower_from_jax(tree[t], t, n) for t in TOWERS}


def load_into(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Strict load in the module's own dtypes and device: a missing,
    unexpected or mis-shaped key raises."""
    own = module.state_dict()
    bad = [(k, tuple(v.shape), tuple(own[k].shape)) for k, v in state_dict.items()
           if k in own and tuple(v.shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"{len(bad)} shape mismatches (first 10): {bad[:10]}")
    module.load_state_dict({k: v.to(own[k].dtype) if k in own else v
                            for k, v in state_dict.items()}, strict=True)

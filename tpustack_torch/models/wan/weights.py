"""Wan weights: JAX parameter trees -> the port's ``state_dict``s, and a
seeded random init on the device.

The port's modules carry the released checkpoints' names
(``wan2.1_t2v_1.3B`` DiT, ``umt5_xxl`` text encoder, ``wan_2.1_vae``), so a
tree from the JAX package maps onto them by that package's own rule
(``tpustack/models/wan/weights.py``: ``dit_key``, ``umt5_key``,
``vae_decoder_key`` and the inverse layout transforms of
``export_wan_state_dict``).  This module is the port's copy of that rule:

- flax Dense kernel ``[I, O]``            -> torch Linear ``[O, I]``
- flax Conv3d kernel ``[kf, kh, kw, I, O]`` -> torch ``[O, I, kf, kh, kw]``
- flax Conv2d kernel ``[kh, kw, I, O]``     -> torch ``[O, I, kh, kw]``
- the VAE attention's Dense ``[I, O]``    -> torch 1x1 Conv2d ``[O, I, 1, 1]``
- VAE RMS ``gamma`` ``(C,)``              -> ``(C,1,1,1)``, or ``(C,1,1)`` in
  the attention block
- norm scales / biases, embeddings, ``modulation`` -> as they are

A later standard-library safetensors reader can load the real files into the
same modules with ``strict=True``.  Loading is strict: :func:`load_into`
raises on a missing, unexpected or mis-shaped key.

:func:`init_random` draws full-width weights on the module's own device from
an explicit ``torch.Generator``, so umt5-xxl's 5.7 B parameters are never
drawn on the host; :func:`build` makes a module on the ``meta`` device, casts
it to the compute dtype with its float32 parts kept, and only then gives it
storage, so a bf16 model never passes through float32.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

Tree = Mapping[str, Any]
Path = Tuple[str, ...]
TOWERS = ("text_encoder", "dit", "vae_decoder")


def _flatten(tree: Tree, prefix: Path = ()) -> Dict[Path, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _ident(w):
    return w


def _linear(w):
    return np.transpose(w)


def _conv3d(w):
    return np.transpose(w, (4, 3, 0, 1, 2))


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _pointwise(w):
    return np.transpose(w)[:, :, None, None]


def _gamma3(w):
    return np.reshape(w, (-1, 1, 1, 1))


def _gamma2(w):
    return np.reshape(w, (-1, 1, 1))


def _wb(base: str, leaf: str, kernel_fn: Callable) -> Tuple[str, Callable]:
    return (f"{base}.weight", kernel_fn) if leaf == "kernel" else (f"{base}.bias", _ident)


_DIT_SIMPLE = {"t_proj_1": "time_embedding.0", "t_proj_2": "time_embedding.2",
               "text_proj_1": "text_embedding.0", "text_proj_2": "text_embedding.2",
               "time_proj": "time_projection.1", "unpatch": "head.head"}
_DIT_BLOCK = {"q": "self_attn.q", "k": "self_attn.k", "v": "self_attn.v", "o": "self_attn.o",
              "xq": "cross_attn.q", "xk": "cross_attn.k", "xv": "cross_attn.v",
              "xo": "cross_attn.o", "ffn_in": "ffn.0", "ffn_out": "ffn.2"}
_DIT_NORMS = {"q_norm": "self_attn.norm_q", "k_norm": "self_attn.norm_k",
              "xq_norm": "cross_attn.norm_q", "xk_norm": "cross_attn.norm_k"}


def dit_key(path: Path) -> Tuple[str, Callable]:
    """A flax DiT param path -> (state_dict key, layout transform)."""
    head, leaf = path[0], path[-1]
    if head == "patch_embed":
        return _wb("patch_embedding", leaf, _conv3d)
    if head in _DIT_SIMPLE:
        return _wb(_DIT_SIMPLE[head], leaf, _linear)
    if head == "head_modulation":
        return "head.modulation", _ident
    if head.startswith("block_"):
        b, mid = f"blocks.{int(head.split('_')[1])}", path[1]
        if mid == "modulation":
            return f"{b}.modulation", _ident
        if mid in _DIT_BLOCK:
            return _wb(f"{b}.{_DIT_BLOCK[mid]}", leaf, _linear)
        if mid in _DIT_NORMS:
            return f"{b}.{_DIT_NORMS[mid]}.weight", _ident
        if mid == "norm3":
            return f"{b}.norm3.{'weight' if leaf == 'scale' else 'bias'}", _ident
    raise KeyError(f"unmapped DiT path {'/'.join(path)}")


def _int8_leaf(base: str, leaf: str, weight_fn: Callable) -> Tuple[str, Callable]:
    """A dense or embedding leaf of a float or weight-only int8 tree: the
    per-channel ``scale`` of an int8 layer keeps its name and layout."""
    if leaf == "scale":
        return f"{base}.scale", _ident
    return f"{base}.weight", weight_fn


def umt5_key(path: Path) -> Tuple[str, Callable]:
    """A flax UMT5 param path (of the float tower, or of the int8 tower
    ``tpustack.ops.quant.quantize_params`` makes) -> (state_dict key,
    layout transform)."""
    head = path[0]
    if head == "embed":
        return _int8_leaf("shared", path[-1], _ident)
    if head == "final_norm":
        return "encoder.final_layer_norm.weight", _ident
    if head.startswith("block_"):
        b, mid = f"encoder.block.{int(head.split('_')[1])}", path[1]
        if mid == "attn":
            return _int8_leaf(f"{b}.layer.0.SelfAttention.{path[2]}", path[-1], _linear)
        if mid == "rel_bias":
            return f"{b}.layer.0.SelfAttention.relative_attention_bias.weight", _ident
        if mid == "norm_attn":
            return f"{b}.layer.0.layer_norm.weight", _ident
        if mid in ("wi_0", "wi_1", "wo"):
            return _int8_leaf(f"{b}.layer.1.DenseReluDense.{mid}", path[-1], _linear)
        if mid == "norm_ffn":
            return f"{b}.layer.1.layer_norm.weight", _ident
    raise KeyError(f"unmapped UMT5 path {'/'.join(path)}")


_VAE_RES = {"conv_1": "residual.2", "conv_2": "residual.6", "skip": "shortcut"}
_VAE_MID = {"mid_res_0": "middle.0", "mid_attn": "middle.1", "mid_res_1": "middle.2"}


def _vae_block(base: str, path: Path) -> Tuple[str, Callable]:
    sub, leaf = path[1], path[-1]
    if sub in _VAE_RES:
        return _wb(f"{base}.{_VAE_RES[sub]}", leaf, _conv3d)
    if sub in ("norm_1", "norm_2"):
        return f"{base}.residual.{0 if sub == 'norm_1' else 3}.gamma", _gamma3
    if sub == "norm":
        return f"{base}.norm.gamma", _gamma2
    if sub in ("qkv", "proj"):
        return _wb(f"{base}.{'to_qkv' if sub == 'qkv' else 'proj'}", leaf, _pointwise)
    if sub == "conv":
        return _wb(f"{base}.resample.1", leaf, _conv2d)
    if sub == "time_conv":
        return _wb(f"{base}.time_conv", leaf, _conv3d)
    raise KeyError(f"unmapped VAE sub-block path {base}/{'/'.join(path)}")


def vae_decoder_key(path: Path) -> Tuple[str, Callable]:
    """A flax WanVAEDecoder param path (``conv_z`` is the top-level
    ``conv2``) -> (state_dict key, layout transform)."""
    path = tuple(p for p in path if p != "Conv_0")  # WanCausalConv3d's wrapper
    head, leaf = path[0], path[-1]
    if head == "conv_z":
        return _wb("conv2", leaf, _conv3d)
    if head == "conv_in":
        return _wb("decoder.conv1", leaf, _conv3d)
    if head == "head_norm":
        return "decoder.head.0.gamma", _gamma3
    if head == "head_conv":
        return _wb("decoder.head.2", leaf, _conv3d)
    if head in _VAE_MID:
        return _vae_block(f"decoder.{_VAE_MID[head]}", path)
    if head.startswith("up_"):
        return _vae_block(f"decoder.upsamples.{int(head.split('_')[1])}", path)
    raise KeyError(f"unmapped VAE path {'/'.join(path)}")


_KEY_FNS = {"text_encoder": umt5_key, "dit": dit_key, "vae_decoder": vae_decoder_key}


def tower_from_jax(tree: Tree, tower: str) -> Dict[str, torch.Tensor]:
    """One tower's flax tree (numpy leaves) -> a ``state_dict``: float
    leaves as float32, the int8 leaves of a quantised tower as int8."""
    key_fn = _KEY_FNS[tower]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree).items():
        key, transform = key_fn(path)
        if key in out:
            raise ValueError(f"duplicate key {key!r} (from {'/'.join(path)})")
        w = np.asarray(leaf)
        w = transform(w if w.dtype == np.int8 else w.astype(np.float32))
        out[key] = torch.tensor(np.ascontiguousarray(w))
    return out


def params_from_jax(tree: Tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX Wan pipeline's parameter tree (``{"text_encoder", "dit",
    "vae_decoder", ...}`` of nested dicts of numpy arrays) -> ``{tower:
    state_dict}``.  Other towers (the VAE encoder) are not on the serving
    path and are ignored."""
    missing = [t for t in TOWERS if t not in tree]
    if missing:
        raise ValueError(f"parameter tree lacks {missing}")
    return {t: tower_from_jax(tree[t], t) for t in TOWERS}


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


def build(factory: Callable[[], nn.Module], dtype: torch.dtype, float32: Iterable[str],
          device: torch.device) -> nn.Module:
    """``factory()`` on the meta device, cast to ``dtype`` except parameters
    with a name component in ``float32``, then given (uninitialised)
    storage on ``device``: fill it with :func:`init_random` or
    :func:`load_into`."""
    keep = set(float32)
    with torch.device("meta"):
        module = factory()
    for name, p in module.named_parameters():
        p.data = p.data.to(torch.float32 if keep & set(name.split(".")) else dtype)
    return module.to_empty(device=device).eval().requires_grad_(False)


def init_random(module: nn.Module, gen: torch.Generator) -> None:
    """Shape-exact random weights from ``gen`` on the module's device, in
    parameter order: lecun-normal weights of linear and conv layers (std
    ``1/sqrt(fan_in)``, ``head.head`` included, so a random DiT predicts a
    non-zero velocity), zero biases, unit norm scales and ``gamma``, token
    embeddings at std ``dim**-0.5``, and ``modulation`` offsets and the
    relative position bias at std 0.02 (flax's inits for those)."""
    with torch.no_grad():
        for name, m in module.named_modules():
            own = dict(m.named_parameters(recurse=False))
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                std = 0.02 if name.endswith("relative_attention_bias") else m.embedding_dim ** -0.5
                m.weight.normal_(0.0, std, generator=gen)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            else:
                for pname, p in own.items():
                    if pname == "modulation":
                        p.normal_(0.0, 0.02, generator=gen)
                    elif pname in ("weight", "gamma"):
                        p.fill_(1.0)
                    else:
                        raise ValueError(f"no init rule for {name}.{pname}")

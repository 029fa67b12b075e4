"""Weight-only int8 quantisation (per output channel): the port of
``tpustack/ops/quant.py``.

Weights live on the device as ``int8`` with one float32 scale per output
channel (symmetric absmax / 127); embedding tables take one scale per
vocabulary row.  Activations stay in the compute dtype (weight-only), and
the layers keep the JAX modules' rounding points:

- :class:`Int8Dense`: the int8 weight is widened to the compute dtype
  (exact: every int8 value is a bf16), multiplied with float32
  accumulation and a float32 result, then scaled (and biased) in float32
  and rounded ONCE to the output dtype.  On CUDA the product is
  ``torch.mm(..., out_dtype=torch.float32)``; the widened copy of the
  weight is a transient of one layer.  A kernel that reads the int8 weight
  straight into the tensor cores (W8A16) is speed work, not this module.
- :class:`Int8Embed`: gather, widen to float32, scale in float32, then cast
  to the compute dtype.

State-dict layout (the torch ``Linear`` convention, so a JAX ``{kernel
[in, out] int8, scale}`` tree maps here by a transpose and no
requantisation, ``models.llama_weights.params_from_jax``):
``weight`` int8 ``[out, in]``, ``scale`` float32 ``[out]``, optional float32
``bias``; an embedding's ``weight`` int8 ``[V, D]`` and ``scale`` float32
``[V]``.

:func:`quantize_module_` swaps a float model's layers for their int8 forms
in place, one layer at a time, so the peak is the float model plus one
layer; :func:`quantize_params` does the same to a state dict, consuming it
key by key as the JAX ``quantize_params`` consumes its tree.  Both round
half to even (``torch.round``, as ``jnp.round``), so they give the JAX
function's int8 values and scales element for element.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: Llama/Qwen projections (the JAX default set)
QUANTIZABLE = frozenset({
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
})

#: UMT5 encoder (the Wan text tower): attention and gated-GELU FFN
UMT5_QUANTIZABLE = frozenset({"q", "k", "v", "o", "wi_0", "wi_1", "wo"})

#: embedding modules quantised per row by default (the umt5 tower's table
#: is the port's ``shared``, the JAX tree's ``embed``)
EMBED_KEYS = frozenset({"embed_tokens"})

#: rows quantised per step: bounds the float32 transient of a large table
#: (Qwen2.5's 152064 x 3584 lm_head) to a slice
_ROWS_PER_STEP = 8192

#: XLA compiles the JAX ``absmax / 127.0`` to a multiply by the float32
#: reciprocal; the same multiply keeps the scales equal to the last bit
_INV_127 = 1.0 / 127.0


def _absmax_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 of a 2-D float tensor: ``(int8 [R, C], f32
    [R])``, in float32 and in slices of rows."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
    for lo in range(0, w.shape[0], _ROWS_PER_STEP):
        wf = w[lo:lo + _ROWS_PER_STEP].float()
        absmax = wf.abs().amax(dim=1)
        s = torch.where(absmax > 0, absmax * _INV_127, torch.ones_like(absmax))
        q[lo:lo + _ROWS_PER_STEP] = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(
            torch.int8)
        scale[lo:lo + _ROWS_PER_STEP] = s
    return q, scale


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``Linear`` weight ``[out, in]`` -> ``(int8 [out, in], float32
    scale [out])``, symmetric absmax per output channel (the JAX function
    on the transposed ``[in, out]`` kernel)."""
    return _absmax_rows(weight)


def quantize_rows(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An embedding table ``[V, D]`` -> ``(int8 [V, D], float32 scale
    [V])``, symmetric absmax per vocabulary row (a feature column's absmax
    over a large vocabulary is set by its one most extreme token)."""
    return _absmax_rows(table)


class Int8Dense(nn.Module):
    """``nn.Linear`` for weight-only int8 serving (see the module docstring
    for where it rounds).  ``dtype``: the compute dtype of the product;
    ``out_dtype``: the output's (float32 for an ``lm_head``'s logits)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, out_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype, self.out_dtype = dtype, out_dtype or dtype
        self.register_buffer("weight", torch.zeros((out_features, in_features),
                                                   dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32,
                                                 device=device))
        self.register_buffer("bias", torch.zeros(out_features, dtype=torch.float32,
                                                 device=device) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if x.is_cuda and self.dtype != torch.float32:
            # float32 result of the half-precision product: one rounding,
            # at the output cast below, as the JAX module's epilogue
            y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
            y = y.reshape(*x.shape[:-1], self.out_features)
        else:
            y = F.linear(x, w).float()
        y = y * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.out_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, dtype={self.dtype}, out_dtype={self.out_dtype}")


class Int8Embed(nn.Module):
    """``nn.Embedding`` with an int8 table and a float32 scale per row."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim, self.dtype = num_embeddings, features, dtype
        self.register_buffer("weight", torch.zeros((num_embeddings, features),
                                                   dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(num_embeddings, dtype=torch.float32,
                                                 device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # widen, scale at full float32 precision, THEN cast: a bf16 scale
        # would lose half its mantissa for nothing
        rows = self.weight[ids].float() * self.scale[ids][..., None]
        return rows.to(self.dtype)


def make_dense(quant: Optional[str], in_features: int, out_features: int, *, bias: bool,
               dtype: torch.dtype, out_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """``None`` -> ``nn.Linear`` in ``dtype``; ``"int8"`` -> :class:`Int8Dense`."""
    if quant is None:
        return nn.Linear(in_features, out_features, bias=bias, dtype=dtype)
    if quant == "int8":
        return Int8Dense(in_features, out_features, bias=bias, dtype=dtype, out_dtype=out_dtype)
    raise ValueError(f"unknown quant mode {quant!r} (want None or 'int8')")


@torch.no_grad()
def quantize_module_(module: nn.Module, names: frozenset = QUANTIZABLE,
                     quantize_embed: bool = True, embed_keys: frozenset = EMBED_KEYS,
                     dtype: Optional[torch.dtype] = None,
                     out_dtypes: Optional[Dict[str, torch.dtype]] = None) -> nn.Module:
    """Swap, in place, every ``nn.Linear`` child named in ``names`` for an
    :class:`Int8Dense` and (with ``quantize_embed``) every ``nn.Embedding``
    named in ``embed_keys`` for an :class:`Int8Embed`.  One layer at a time:
    each float weight is dropped before the next is quantised.  ``dtype``:
    the compute dtype of the new layers (default: the float weight's);
    ``out_dtypes``: per child name, an output dtype other than that."""
    out_dtypes = out_dtypes or {}
    # paths, not module objects: a list of modules would keep every float
    # weight alive until the end
    targets = [path.rpartition(".") for path, m in module.named_modules()
               if (isinstance(m, nn.Linear) and path.rpartition(".")[2] in names)
               or (isinstance(m, nn.Embedding) and quantize_embed
                   and path.rpartition(".")[2] in embed_keys)]
    for parent_path, _, name in targets:
        parent = module.get_submodule(parent_path)
        child = getattr(parent, name)
        if isinstance(child, nn.Linear):
            q, s = quantize_kernel(child.weight)
            new = Int8Dense(child.in_features, child.out_features,
                            bias=child.bias is not None, dtype=dtype or child.weight.dtype,
                            out_dtype=out_dtypes.get(name), device=q.device)
            if child.bias is not None:
                new.bias.copy_(child.bias.float())
        else:
            q, s = quantize_rows(child.weight)
            new = Int8Embed(child.num_embeddings, child.embedding_dim,
                            dtype=dtype or child.weight.dtype, device=q.device)
        new.weight.copy_(q)
        new.scale.copy_(s)
        setattr(parent, name, new)
        del child, q, s  # the float weight is freed before the next layer
    return module


def quantize_params(state_dict: Dict[str, torch.Tensor], names: frozenset = QUANTIZABLE,
                    quantize_embed: bool = True,
                    embed_keys: frozenset = EMBED_KEYS) -> Dict[str, torch.Tensor]:
    """A float state dict -> the int8 serving state dict (``{module}.weight``
    int8 and ``{module}.scale`` float32 for every 2-D weight of a module
    named in ``names``, or in ``embed_keys`` when ``quantize_embed``;
    everything else, biases included, passes through).

    **Consumes the input**: each float weight is popped before its int8
    replacement is made, so the peak is the float model plus one weight."""
    out: Dict[str, torch.Tensor] = {}
    for key in list(state_dict):
        v = state_dict.pop(key)
        module, _, leaf = key.rpartition(".")
        owner = module.rpartition(".")[2]
        if leaf == "weight" and getattr(v, "ndim", 0) == 2 and (
                owner in names or (quantize_embed and owner in embed_keys)):
            q, s = (quantize_kernel if owner in names else quantize_rows)(v)
            del v
            out[key], out[f"{module}.scale"] = q, s
        else:
            out[key] = v
    return out

"""UMT5 text encoder for the Wan T2V family, in PyTorch.

Counterpart of ``tpustack/models/wan/umt5.py``: the encoder half of UMT5
(all T2V conditioning needs).  UMT5 differs from T5 in that every layer owns
its relative position bias.  Submodules carry the umt5-xxl checkpoint's
names (``shared``, ``encoder.block.N.layer.0.SelfAttention.q``, ...), so
``state_dict()`` keys are the checkpoint's.

Numerics kept equal to the flax module: T5 RMS norms in float32 with a
float32 scale; self-attention with **no** ``1/sqrt(d)`` scale, the float32
bias added to float32 logits, masked keys at -1e30, a float32 softmax cast
to the compute dtype before P.V; the gated tanh-GELU FFN; the output zeroed
at pad positions.  The attention is plain matmuls, as the JAX package's is
plain einsum: it is not a Pallas kernel there.

With ``quant="int8"`` the q/k/v/o and FFN projections are
:class:`~tpustack_torch.ops.quant.Int8Dense` and the table ``shared`` an
:class:`~tpustack_torch.ops.quant.Int8Embed` (``ops.quant.UMT5_QUANTIZABLE``
and :data:`EMBED_KEYS`), computing in ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpustack_torch.models.wan.config import UMT5Config
from tpustack_torch.ops.quant import Int8Embed, make_dense

NEG_INF = -1e30

#: the embedding module ``ops.quant`` quantises per row in this tower (the
#: JAX tree's ``embed``)
EMBED_KEYS = frozenset({"shared"})


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction or bias, float32 compute."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight.float()).to(x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucketing: half the buckets for each sign, log-spaced
    beyond ``num_buckets // 4`` exact positions.  float32 throughout, in the
    JAX package's order of operations (a float64 log moves values across
    bucket boundaries)."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6) / log_ratio.to(n.device)
                         * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp_max(large, num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class UMT5SelfAttention(nn.Module):
    def __init__(self, c: UMT5Config, dtype: torch.dtype):
        super().__init__()
        inner = c.num_heads * c.head_dim
        self.num_heads, self.head_dim = c.num_heads, c.head_dim
        self.q = make_dense(c.quant, c.dim, inner, bias=False, dtype=dtype)
        self.k = make_dense(c.quant, c.dim, inner, bias=False, dtype=dtype)
        self.v = make_dense(c.quant, c.dim, inner, bias=False, dtype=dtype)
        self.o = make_dense(c.quant, inner, c.dim, bias=False, dtype=dtype)
        # per-layer bias: the UMT5-vs-T5 difference
        self.relative_attention_bias = nn.Embedding(c.rel_buckets, c.num_heads)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        heads = lambda y: y.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)  # noqa: E731
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        bias = self.relative_attention_bias.weight.float()[buckets].permute(2, 0, 1)  # [H, Sq, Sk]
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias[None]
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        return self.o(out)


class _AttentionLayer(nn.Module):
    def __init__(self, c: UMT5Config, dtype: torch.dtype):
        super().__init__()
        self.SelfAttention = UMT5SelfAttention(c, dtype)
        self.layer_norm = T5LayerNorm(c.dim)


class _DenseGatedGelu(nn.Module):
    def __init__(self, c: UMT5Config, dtype: torch.dtype):
        super().__init__()
        self.wi_0 = make_dense(c.quant, c.dim, c.ffn_dim, bias=False, dtype=dtype)
        self.wi_1 = make_dense(c.quant, c.dim, c.ffn_dim, bias=False, dtype=dtype)
        self.wo = make_dense(c.quant, c.ffn_dim, c.dim, bias=False, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class _FFLayer(nn.Module):
    def __init__(self, c: UMT5Config, dtype: torch.dtype):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(c, dtype)
        self.layer_norm = T5LayerNorm(c.dim)


class UMT5Block(nn.Module):
    def __init__(self, c: UMT5Config, dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList([_AttentionLayer(c, dtype), _FFLayer(c, dtype)])

    def forward(self, x: torch.Tensor, mask: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), mask, buckets)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, c: UMT5Config, dtype: torch.dtype):
        super().__init__()
        self.block = nn.ModuleList([UMT5Block(c, dtype) for _ in range(c.num_layers)])
        self.final_layer_norm = T5LayerNorm(c.dim)


class UMT5Encoder(nn.Module):
    """Token ids ``[B, L]`` (+ bool mask) -> embeddings ``[B, L, dim]`` in the
    embedding's dtype, zero at pad positions.  ``dtype``: the compute dtype
    of the int8 layers (the float layers take the dtype their parameters
    are cast to)."""

    def __init__(self, cfg: UMT5Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.shared = (Int8Embed(cfg.vocab_size, cfg.dim, dtype=dtype) if cfg.quant
                       else nn.Embedding(cfg.vocab_size, cfg.dim))
        self.encoder = _Stack(cfg, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor = None) -> torch.Tensor:
        c = self.cfg
        if mask is None:
            mask = torch.ones_like(ids, dtype=torch.bool)
        s = ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], c.rel_buckets,
                                           c.rel_max_distance)
        x = self.shared(ids)
        for blk in self.encoder.block:
            x = blk(x, mask, buckets)
        x = self.encoder.final_layer_norm(x)
        return torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


"""CLIP ViT-L/14 text encoder — the SD1.5 conditioning tower.

Counterpart of ``tpustack/models/sd15/clip.py``: token + learned position
embeddings, pre-LN transformer layers with causal self-attention and
quick-GELU MLPs, a final LayerNorm (``eps`` 1e-5).  Submodules carry the
``transformers`` names, so ``state_dict()`` keys are the checkpoint's
(``text_model.encoder.layers.0.self_attn.q_proj.weight``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from tpustack_torch.models.sd15.config import CLIPTextConfig
from tpustack_torch.ops.attention import dot_product_attention


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: nn.functional.gelu(x, approximate="tanh")  # flax nn.gelu
    raise ValueError(f"unknown activation {name}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, d // self.heads)
        out = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                    split(self.v_proj(x)), causal=True)
        return self.out_proj(out.reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _act(cfg.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = self.position_embedding.weight[: input_ids.shape[1]]
        return self.token_embedding(input_ids) + pos[None]


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.final_layer_norm(x)


class CLIPTextEncoder(nn.Module):
    """``input_ids [B, L] int -> last_hidden_state [B, L, hidden]``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids.long())

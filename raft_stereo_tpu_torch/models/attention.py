"""Relative-position multi-head cross-attention along the image width
(PyTorch port of ``raft_stereo_tpu/models/attention.py``; the reference's
core/madnet2/attention.py and submodule_fusion.py:162-221).

Attention runs along W (the epipolar direction) with (batch, height) as
batch axes, on channel-last [B, H, W, C] tensors, written as explicit
einsums: the relative-position terms and the returned logits need the
logits themselves. The projection keeps the torch packed layout
(``in_proj_weight`` [3C, C], rows q | k | v).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn


class MultiheadAttentionRelative(nn.Module):
    """Width-axis multi-head attention with optional relative position terms.

    q from ``query``, k and v from ``key_value``; with ``pos_enc``
    ([2W-1, C]) two more terms add the query-position and key-position
    interactions (reference attention.py:99-108). Returns (output, attn,
    raw_attn): attn is the softmaxed map summed over heads / heads, raw_attn
    the pre-softmax logits summed over heads."""

    def __init__(self, embed_dim: int, num_heads: int = 1):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key_value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                pos_enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        C, E = self.embed_dim, self.num_heads
        hd = C // E
        B, H, W, _ = query.shape
        w, b = self.in_proj_weight, self.in_proj_bias
        q = query @ w[:C].T + b[:C]
        k, v = (key_value @ w[C:].T + b[C:]).chunk(2, dim=-1)
        scaling = float(hd) ** -0.5
        q = (q * scaling).reshape(B, H, W, E, hd)
        k = k.reshape(B, H, -1, E, hd)
        v = v.reshape(B, H, -1, E, hd)
        attn = torch.einsum("bhwed,bhved->bhewv", q, k)
        if pos_enc is not None:
            # the [W, W', C] table of relative encodings: entry (i, j) is
            # pos_enc[i - j + W' - 1] (reference attention.py:66-75)
            Wp = k.shape[2]
            idx = (torch.arange(W, device=query.device)[:, None]
                   - torch.arange(Wp, device=query.device)[None, :] + Wp - 1)
            rel = pos_enc[idx.reshape(-1)].reshape(W, Wp, C)
            q_r, k_r = (rel @ w[: 2 * C].T + b[: 2 * C]).chunk(2, dim=-1)
            q_r = (q_r * scaling).reshape(W, Wp, E, hd)
            k_r = k_r.reshape(W, Wp, E, hd)
            attn = attn + torch.einsum("bhwed,wved->bhewv", q, k_r)
            attn = attn + torch.einsum("bhved,wved->bhewv", k, q_r)
        if attn_mask is not None:
            attn = attn + attn_mask[None, None, None]
        raw_attn = attn
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhewv,bhved->bhwed", attn, v).reshape(B, H, W, C)
        return self.out_proj(out), attn.sum(dim=2) / E, raw_attn.sum(dim=2)


class TransformerCrossAttnLayer(nn.Module):
    """Pre-norm cross-attention with a residual (reference
    submodule_fusion.py:162-221). Both streams go through ``norm1``, as in
    the reference; ``norm2`` exists (its parameters load) and is unused.

    ``last_layer`` adds STTR's mask: query (left) position i attends key
    positions j <= i only, the positive-disparity constraint (the
    reference's own branch calls a method no class defines)."""

    def __init__(self, hidden_dim: int, nhead: int = 1):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.cross_attn = MultiheadAttentionRelative(hidden_dim, nhead)

    def forward(self, feat_left: torch.Tensor, feat_right: torch.Tensor,
                pos: Optional[torch.Tensor] = None, last_layer: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        attn_mask = None
        if last_layer:
            W = feat_left.shape[2]
            attn_mask = torch.triu(torch.full((W, W), float("-inf"), device=feat_left.device),
                                   diagonal=1)
        out, _, raw_attn = self.cross_attn(self.norm1(feat_left), self.norm1(feat_right),
                                           attn_mask=attn_mask, pos_enc=pos)
        return feat_left + out, raw_attn


__all__ = ["MultiheadAttentionRelative", "TransformerCrossAttnLayer"]

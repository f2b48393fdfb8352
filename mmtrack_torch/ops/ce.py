"""Candidate elimination: attention-guided search-token pruning.

Port of mmtrack_tpu/ops/ce.py (itself a static-shape rebuild of ViPT
attn_blocks.py:21-75). The score is reduced in the attention's dtype the
way jnp.mean does it (f32 sum, divide, round back), and the ranking is a
stable descending argsort, so tied scores keep their token order exactly
as `jnp.argsort(-score)` does (ce.py:71).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def ce_keep_schedule(num_search_tokens: int, ce_loc: Sequence[int],
                     keep_ratios: Sequence[float]) -> tuple[int, ...]:
    """Kept-token count after each CE layer (ceil, attn_blocks.py:40)."""
    lens = []
    cur = num_search_tokens
    for r in keep_ratios:
        cur = math.ceil(r * cur)
        lens.append(cur)
    return tuple(lens)


def ce_keep_lengths(lens_s: int, ce_loc: list[int], keep_ratio: float,
                    depth: int) -> list[int]:
    """The search-token count entering each of `depth` blocks, the counts
    kept after each CE block from `ce_keep_schedule` (the ceiling of
    attn_blocks.py:40; JAX ops/ce.py:17-34)."""
    kept = ce_keep_schedule(lens_s, tuple(ce_loc), [keep_ratio] * len(ce_loc))
    lengths, cur, k = [], lens_s, 0
    for i in range(depth):
        lengths.append(cur)
        if i in ce_loc:
            cur = kept[k]
            k += 1
    return lengths


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.mean semantics for low-precision floats: f32 sum / n, rounded back."""
    return (x.float().sum(dim) / x.shape[dim]).to(x.dtype)


def candidate_elimination(attn: torch.Tensor, tokens: torch.Tensor, lens_t: int,
                          lens_keep: int, global_index: torch.Tensor,
                          box_mask_z: torch.Tensor | None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the `lens_keep` search tokens most attended by the template.

    attn (B, H, L_t+L_s, L_t+L_s) probabilities; tokens (B, L_t+L_s, C);
    global_index (B, L_s) original search-grid index of each live token;
    box_mask_z (B, L_t) weights of the voting template rows, or None.
    Returns (tokens (B, L_t+lens_keep, C), keep_index (B, lens_keep),
    removed_index (B, L_s-lens_keep)).
    """
    dt = attn.dtype
    attn_t = attn[:, :, :lens_t, lens_t:]                     # (B, H, L_t, L_s)
    if box_mask_z is not None:
        w = box_mask_z.to(dt)
        denom = torch.clamp(w.float().sum(1, keepdim=True), min=1e-9).to(dt)   # (B, 1)
        score = torch.einsum("bhts,bt->bhs", attn_t.float(), w.float()).to(dt)
        score = _mean(score / denom[:, None, :], 1)
    else:
        score = _mean(_mean(attn_t, 2), 1)                     # (B, L_s)

    order = torch.argsort(-score.float(), dim=1, stable=True)
    topk_idx = order[:, :lens_keep]
    non_topk_idx = order[:, lens_keep:]
    keep_index = torch.gather(global_index, 1, topk_idx)
    removed_index = torch.gather(global_index, 1, non_topk_idx)

    C = tokens.shape[-1]
    tokens_t = tokens[:, :lens_t]
    kept = torch.gather(tokens[:, lens_t:], 1, topk_idx[..., None].expand(-1, -1, C))
    return torch.cat([tokens_t, kept], dim=1), keep_index, removed_index


def recover_search_tokens(tokens_s: torch.Tensor, global_index: torch.Tensor,
                          lens_x: int) -> torch.Tensor:
    """Scatter surviving search tokens back to the full (B, lens_x, C) grid;
    pruned positions become zeros."""
    B, _, C = tokens_s.shape
    out = tokens_s.new_zeros((B, lens_x, C))
    return out.scatter(1, global_index[..., None].expand(-1, -1, C), tokens_s)


def gather_search_tokens(tokens_s_full: torch.Tensor,
                         global_index: torch.Tensor) -> torch.Tensor:
    """Inverse of recover_search_tokens: pick live tokens from the full grid."""
    C = tokens_s_full.shape[-1]
    return torch.gather(tokens_s_full, 1, global_index[..., None].expand(-1, -1, C))

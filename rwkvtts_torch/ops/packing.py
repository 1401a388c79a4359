"""Vectorized segment packing (counterpart of rwkvtts_tpu/ops/packing.py).

Multi-segment prompts ([instr][audio][hints][answer], [text][audio]) are
packed right-aligned by each row's valid count: per-segment cumsum ranks
give every valid position its destination, and one scatter a segment and
tensor writes them, every row at once. The reference splices rows with a
host loop over the batch (model/llm/rwkv_asr.py:92-130).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

IGNORE_INDEX = -100


def right_align_pack(
    segments: Sequence[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]],
    T_total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack (emb, mask, labels?) segments right-aligned by valid count.

    segments: (emb (B, L_k, C), mask (B, L_k), labels (B, L_k) or None).
    Returns (packed_emb (B, T_total, C) in the first segment's dtype,
    packed_mask (B, T_total) int32, packed_labels (B, T_total) int64 with
    -100 fill). Differentiable in the embeddings."""
    emb0 = segments[0][0]
    B, _, C = emb0.shape
    dev = emb0.device
    masks = [m.to(torch.long) for _, m, _ in segments]
    suffix = torch.zeros(B, dtype=torch.long, device=dev)
    suffixes = []
    for m in reversed(masks):
        suffix = suffix + m.sum(1)
        suffixes.append(suffix)
    suffixes.reverse()  # suffixes[k]: the valid positions of segments k..n-1
    out_emb = emb0.new_zeros(B, T_total + 1, C)
    out_mask = torch.zeros(B, T_total + 1, dtype=torch.int32, device=dev)
    out_lab = torch.full((B, T_total + 1), IGNORE_INDEX, dtype=torch.long, device=dev)
    for (emb, _, lab), m, suf in zip(segments, masks, suffixes):
        dest = T_total - suf[:, None] + torch.cumsum(m, 1) - 1
        # Invalid positions, and overflow (more valid positions than
        # T_total would make dest negative), go to the dump slot at index
        # T_total. Several writes land there and which one wins is not
        # defined; that is harmless only because the slot is cropped off
        # below (and its gradient is zero).
        dest = torch.where((m > 0) & (dest >= 0), dest, T_total)
        out_emb = out_emb.scatter(1, dest[..., None].expand(-1, -1, C), emb.to(out_emb.dtype))
        out_mask = out_mask.scatter(1, dest, m.to(torch.int32))
        if lab is not None:
            out_lab = out_lab.scatter(1, dest, torch.where(m > 0, lab.to(torch.long),
                                                           IGNORE_INDEX))
    return out_emb[:, :T_total], out_mask[:, :T_total], out_lab[:, :T_total]

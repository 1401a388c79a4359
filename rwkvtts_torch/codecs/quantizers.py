"""Vector quantizers of the BiCodec codec: factorized VQ, FSQ and residual
FSQ (counterpart of rwkvtts_tpu/codecs/quantizers.py).

Channels-last and functional, parameters as nested dicts with the JAX
tree's names. The token id spaces are contracts with the speech LM:
  * Spark semantic tokens: the factorized VQ, 8192 codes;
  * Spark global tokens: residual FSQ at levels [4] * 6, 4096 ids, 32 an
    utterance.
The nearest code is an argmax of cosine similarity (both sides
l2-normalised); FSQ rounds half to even (``torch.round``, as
``jnp.round``), and the straight-through sums are written in the JAX
package's order so that the indices come out bit-equal.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from rwkvtts_torch.codecs import nn

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Factorized VQ (Spark semantic tokens)
# ---------------------------------------------------------------------------


def factorized_vq_init(g: torch.Generator, input_dim: int, codebook_size: int,
                       codebook_dim: int) -> Params:
    p: Params = {"codebook": torch.randn(codebook_size, codebook_dim, generator=g,
                                         device=g.device)}
    if input_dim != codebook_dim:
        # the reference's 1x1 convolutions are linears channels-last
        p["in_project"] = nn.linear_init(g, input_dim, codebook_dim)
        p["out_project"] = nn.linear_init(g, codebook_dim, input_dim)
    return p


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-24)


def _fvq_nearest(p: Params, z_e: torch.Tensor) -> torch.Tensor:
    """z_e (B, T, D_code) -> indices (B, T): the largest cosine similarity."""
    return torch.argmax(_l2n(z_e) @ _l2n(p["codebook"]).T, -1)


def factorized_vq_tokenize(p: Params, z: torch.Tensor) -> torch.Tensor:
    """z (B, T, input_dim) -> semantic token ids (B, T)."""
    return _fvq_nearest(p, nn.linear(p["in_project"], z) if "in_project" in p else z)


def factorized_vq_detokenize(p: Params, indices: torch.Tensor) -> torch.Tensor:
    """indices (B, T) -> z_q (B, T, input_dim)."""
    z_q = p["codebook"][indices]
    return nn.linear(p["out_project"], z_q) if "out_project" in p else z_q


def factorized_vq_forward(p: Params, z: torch.Tensor, commitment: float = 0.25,
                          codebook_loss_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """The training forward: the straight-through z_q and the commitment and
    codebook losses, with the codebook's perplexity and live-code count.
    z (B, T, input_dim)."""
    z_e = nn.linear(p["in_project"], z) if "in_project" in p else z
    idx = _fvq_nearest(p, z_e)
    z_q_raw = p["codebook"][idx]
    commit = ((z_e - z_q_raw.detach()) ** 2).mean() * commitment
    codebook = ((z_q_raw - z_e.detach()) ** 2).mean() * codebook_loss_weight
    z_q = z_e + (z_q_raw - z_e).detach()
    z_q = nn.linear(p["out_project"], z_q) if "out_project" in p else z_q
    counts = torch.bincount(idx.reshape(-1), minlength=p["codebook"].shape[0]).float()
    probs = counts / idx.numel()
    return {"z_q": z_q, "indices": idx, "vq_loss": commit + codebook,
            "perplexity": torch.exp(-(probs * torch.log(probs + 1e-10)).sum()),
            "active_num": (counts > 0).sum().float()}


# ---------------------------------------------------------------------------
# FSQ (finite scalar quantization)
# ---------------------------------------------------------------------------


def _levels(levels: Sequence[int], like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(list(levels), dtype=dtype, device=like.device)


def fsq_basis(levels: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    b = [1]
    for lv in levels[:-1]:
        b.append(b[-1] * lv)
    return torch.tensor(b, dtype=torch.int32, device=like.device)


def fsq_bound(z: torch.Tensor, levels: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    lv = _levels(levels, z)
    half_l = (lv - 1) * (1 + eps) / 2
    offset = torch.where(lv % 2 == 0, 0.5, 0.0)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Round to the levels (half to even) with a straight-through gradient,
    divided by the half width (codes in about [-1, 1])."""
    bounded = fsq_bound(z, levels)
    q = bounded + (torch.round(bounded) - bounded).detach()
    return q / torch.floor(_levels(levels, z) / 2)


def fsq_codes_to_indices(codes: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    half_width = torch.floor(_levels(levels, codes) / 2)
    zhat = codes * half_width + half_width
    return (zhat * fsq_basis(levels, codes)).sum(-1).to(torch.int32)


def fsq_indices_to_codes(indices: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    lv = _levels(levels, indices, torch.int32)
    level_idx = (indices[..., None] // fsq_basis(levels, indices)) % lv
    half_width = lv // 2
    return (level_idx - half_width) / half_width.float()


def fsq_forward(z: torch.Tensor, levels: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (..., len(levels)) -> (codes, indices); no projections (the
    residual FSQ owns them)."""
    codes = fsq_quantize(z.float(), levels)
    return codes.to(z.dtype), fsq_codes_to_indices(codes, levels)


# ---------------------------------------------------------------------------
# Residual FSQ (Spark global / speaker tokens)
# ---------------------------------------------------------------------------


def residual_fsq_init(g: torch.Generator, dim: int, levels: Sequence[int]) -> Params:
    p: Params = {}
    if len(levels) != dim:
        p["project_in"] = nn.linear_init(g, dim, len(levels))
        p["project_out"] = nn.linear_init(g, len(levels), dim)
    return p


def residual_fsq_scales(levels: Sequence[int], num_quantizers: int,
                        like: torch.Tensor) -> torch.Tensor:
    lv = _levels(levels, like)
    return torch.stack([(lv - 1) ** -i for i in range(num_quantizers)])


def residual_fsq_forward(p: Params, x: torch.Tensor, levels: Sequence[int],
                         num_quantizers: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, dim) -> (quantized (B, N, dim), indices (B, N, Q))."""
    scales = residual_fsq_scales(levels, num_quantizers, x)
    residual = nn.linear(p["project_in"], x) if "project_in" in p else x
    out = torch.zeros_like(residual)
    all_idx = []
    for qi in range(num_quantizers):
        codes, idx = fsq_forward(residual / scales[qi], levels)
        quantized = codes * scales[qi]
        residual = residual - quantized.detach()
        out = out + quantized
        all_idx.append(idx)
    out = nn.linear(p["project_out"], out) if "project_out" in p else out
    return out, torch.stack(all_idx, -1)


def residual_fsq_output_from_indices(p: Params, indices: torch.Tensor, levels: Sequence[int],
                                     num_quantizers: int = 1) -> torch.Tensor:
    """indices (B, N, Q) -> (B, N, dim)."""
    codes = fsq_indices_to_codes(indices, levels)  # (B, N, Q, D)
    scales = residual_fsq_scales(levels, num_quantizers, codes)
    summed = (codes * scales[None, None]).sum(2)
    return nn.linear(p["project_out"], summed) if "project_out" in p else summed

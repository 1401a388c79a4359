"""Speaker similarity (SIM) for the seed-tts eval (counterpart of
rwkvtts_tpu/eval/sim.py): the cosine between the speaker embeddings of a
synthesized utterance and of its prompt clip, with a pluggable embedder;
``campplus_embed_fn`` gives the port's CAM++ x-vector
(codecs/campplus.py), the model family the community's SIM evals use.

Raw cosines between x-vectors sit near 1 for any two speech clips (a
shared dominant direction), so ``evaluate_sim`` also reports the cosines
after subtracting the eval set's mean embedding (``centered_mean``), and
``discriminability`` checks that same-speaker pairs score above
different-speaker pairs on that centered score.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkvtts_torch.codecs import campplus as cp


def cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    """The cosine of two vectors in f64; 0 when either is zero."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / denom) if denom > 0 else 0.0


@dataclasses.dataclass
class SIMResult:
    mean: float                      # the protocol's number: mean raw cosine
    per_utt: List[float]
    centered_mean: float = 0.0       # mean cosine around the set's mean embedding
    per_utt_centered: Optional[List[float]] = None


def evaluate_sim(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    embed_fn: Callable[[np.ndarray], np.ndarray],
) -> SIMResult:
    """pairs: (synth_wav, prompt_wav), f32 at 16 kHz; embed_fn: wav ->
    speaker embedding (e.g. ``campplus_embed_fn``)."""
    if not pairs:
        return SIMResult(0.0, [], 0.0, [])
    embs = [(embed_fn(synth), embed_fn(prompt)) for synth, prompt in pairs]
    sims = [cosine_sim(a, b) for a, b in embs]
    mu = np.mean([e for ab in embs for e in ab], axis=0)
    cent = [cosine_sim(a - mu, b - mu) for a, b in embs]
    return SIMResult(mean=float(np.mean(sims)), per_utt=sims,
                     centered_mean=float(np.mean(cent)), per_utt_centered=cent)


def discriminability(
    same_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    diff_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    embed_fn: Callable[[np.ndarray], np.ndarray],
) -> dict:
    """Whether the centered score puts same-speaker pairs above
    different-speaker pairs: the two means and their gap."""
    all_pairs = list(same_pairs) + list(diff_pairs)
    embs = [(embed_fn(a), embed_fn(b)) for a, b in all_pairs]
    mu = np.mean([e for ab in embs for e in ab], axis=0)
    cent = [cosine_sim(a - mu, b - mu) for a, b in embs]
    n = len(same_pairs)
    same_mean = float(np.mean(cent[:n])) if n else 0.0
    diff_mean = float(np.mean(cent[n:])) if len(cent) > n else 0.0
    return {"same_mean": same_mean, "diff_mean": diff_mean, "gap": same_mean - diff_mean,
            "discriminates": same_mean > diff_mean}


def campplus_embed_fn(params, cfg: Optional[cp.CampplusConfig] = None):
    """An embed_fn on the port's CAM++: a numpy wav at 16 kHz -> its
    x-vector (numpy), computed on the parameters' device."""
    cfg = cfg or cp.CampplusConfig()
    device = next(_leaves(params)).device

    @torch.inference_mode()
    def fn(wav: np.ndarray) -> np.ndarray:
        w = torch.from_numpy(np.asarray(wav, np.float32))[None].to(device)
        return cp.embed_wav(params, cfg, w)[0].cpu().numpy()

    return fn


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree

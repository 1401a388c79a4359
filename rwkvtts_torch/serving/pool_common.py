"""Host-side helpers of the slot-pool engines (a copy of
rwkvtts_tpu/serving/pool_common.py): prompt bucketing, admission batch
stacking, int32-safe request parameters."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def clamp_seed(seed: int) -> int:
    """Untrusted request seeds are masked to 31 bits, so an oversized seed
    cannot fail an admission on the pool thread; determinism per input
    value is kept."""
    return int(seed) & 0x7FFFFFFF


def clamp_i32(n: int) -> int:
    return max(0, min(int(n), 2**31 - 1))


def round_width(width: int, prompt_cap: int) -> int:
    """The admission pad rule: prompt_cap doubled until it fits. Warmup
    widths round through this, so they are the widths admissions use."""
    cap = prompt_cap
    while cap < width:
        cap *= 2
    return cap


def warmup_widths(widths, prompt_cap: int) -> List[int]:
    """Normalize a user width list to the actual admission buckets."""
    return sorted({round_width(w, prompt_cap) for w in (widths or [prompt_cap])})


def pad_prompt(batch: Dict[str, np.ndarray], prompt_cap: int) -> Dict[str, np.ndarray]:
    """Left-pad a B=1 prompt batch to its admission bucket, in numpy
    (int32), so an admission costs one host-to-device copy."""
    T = batch["tokens"].shape[1]
    cap = round_width(T, prompt_cap)
    pad = cap - T
    return {
        k: np.pad(np.asarray(v, np.int32), ((0, 0), (pad, 0)))
        for k, v in batch.items()
    }


def stack_admission(pbs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-request padded prompts into one admission batch (left-pad
    to the widest bucket present)."""
    cap = max(p["tokens"].shape[1] for p in pbs)
    return {
        k: np.concatenate(
            [np.pad(p[k], ((0, 0), (cap - p[k].shape[1], 0))) for p in pbs],
            axis=0,
        )
        for k in pbs[0]
    }

"""Golden fixtures (a copy of the reader half of
rwkvtts_tpu/utils/fixtures.py): a fixture under tests/goldens holds a
state dict's shape table, a seed and the reference's inputs and outputs;
the weights are regenerated from (shapes, seed), the same bytes the
capture fed the reference."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synth_state_dict(shapes: Dict[str, tuple], seed: int) -> Dict[str, np.ndarray]:
    """A deterministic state dict in the reference's key layout: norm
    scales, weight-norm magnitudes and snake alphas near 1, running
    variances positive, the rest small normals; one generator over the
    sorted keys."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k in sorted(shapes):
        shp = tuple(int(x) for x in shapes[k])
        if k.endswith("num_batches_tracked"):
            out[k] = np.zeros(shp, np.int64)
        elif k.endswith("running_var"):
            out[k] = np.clip(1.0 + 0.1 * rng.standard_normal(shp), 0.5, None).astype(np.float32)
        elif k.endswith("running_mean"):
            out[k] = (0.1 * rng.standard_normal(shp)).astype(np.float32)
        elif (k.endswith("weight_g") or k.endswith("alpha")
              or (k.endswith(".weight") and len(shp) == 1)):
            out[k] = (1.0 + 0.1 * rng.standard_normal(shp)).astype(np.float32)
        else:
            out[k] = (0.1 * rng.standard_normal(shp)).astype(np.float32)
    return out


def load_golden(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(the synthetic state dict, {io name: array}) of a golden fixture."""
    z = np.load(path)
    shapes = {k[len("shape/"):]: tuple(z[k].tolist()) for k in z.files if k.startswith("shape/")}
    io = {k[len("io/"):]: z[k] for k in z.files if k.startswith("io/")}
    return synth_state_dict(shapes, int(z["meta/seed"])), io

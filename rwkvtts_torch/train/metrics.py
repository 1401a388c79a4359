"""Training metrics and logging (counterpart of rwkvtts_tpu/train/metrics.py,
without JAX): KT/s, Gtokens and loss to <run_dir>/metrics.jsonl, and to
wandb when a project is named. One process, one device: every record is
written (the JAX package's rank-0 gating comes with the multi-device
slice). Asking for wandb without the package installed raises; the JAX
package logs and carries on.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

log = logging.getLogger("rwkvtts_torch")


def setup_logging(level: Optional[str] = None) -> None:
    level = level or os.environ.get("LOG_LEVEL", "INFO")
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


def wandb_run(project: str, run_name: Optional[str], run_dir: str):
    """A wandb run (the import is gated: wandb is optional, and a project
    named without it installed is an error)."""
    try:
        import wandb
    except ImportError as e:
        raise RuntimeError(f"--wandb-project {project}: the wandb package is not "
                           "installed") from e
    return wandb.init(project=project, name=run_name, dir=run_dir)


class MetricLogger:
    """Appends one JSON record a logged step to <run_dir>/metrics.jsonl, and
    logs it to a wandb run of `project` when one is named."""

    def __init__(self, run_dir: str, project: Optional[str] = None,
                 run_name: Optional[str] = None):
        os.makedirs(run_dir, exist_ok=True)
        self._wandb = wandb_run(project, run_name, run_dir) if project else None
        self._file = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tokens_total = 0

    def log(self, step: int, metrics: Dict[str, Any], tokens: int = 0) -> None:
        self._tokens_total += int(tokens)
        rec = {
            "step": step,
            "time": time.perf_counter(),
            "gtokens": self._tokens_total / 1e9,
            **{k: float(v) for k, v in metrics.items()},
        }
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    def close(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


class Throughput:
    """KT/s over windows of at least one second."""

    def __init__(self):
        self.t_last = time.perf_counter()
        self.tok_window = 0

    def update(self, n_tokens: int) -> Optional[float]:
        self.tok_window += int(n_tokens)
        now = time.perf_counter()
        dt = now - self.t_last
        if dt >= 1.0:
            kts = self.tok_window / dt / 1e3
            self.t_last = now
            self.tok_window = 0
            return kts
        return None

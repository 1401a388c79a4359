"""Training metrics and logging (counterpart of rwkvtts_tpu/train/metrics.py,
without JAX): KT/s, Gtokens and loss to <run_dir>/metrics.jsonl. One
process, one device: every record is written (the JAX package's rank-0
gating and wandb sink come with the multi-device slice).
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


class MetricLogger:
    """Appends one JSON record a logged step to <run_dir>/metrics.jsonl."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
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

    def close(self):
        self._file.close()


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

"""Profiling: per-phase wall counters, steady-state timing and a
torch.profiler trace (counterpart of rwkvtts_tpu/utils/profiling.py).

  * ``PhaseTimer``: calls, seconds, tokens and audio seconds by phase, with
    tokens/s and the real-time factor, one summary;
  * ``measure(fn, *args)``: the first call's time against the steady
    state's, each ended by ``sync``;
  * ``sync(x)``: waits for the CUDA devices that `x`'s tensors live on
    (a host clock without it measures the enqueue, not the work);
  * ``trace(dir)``: a ``torch.profiler`` trace of a block, CPU and CUDA,
    written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator

import torch


def _tensors(x) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x) -> None:
    """``torch.cuda.synchronize`` on every CUDA device `x` (a tensor or a
    tree of them) has tensors on; nothing for CPU tensors."""
    for d in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """A torch.profiler trace (CPU, and CUDA where there is a device) of the
    block, exported to <log_dir>/<name> (chrome://tracing, Perfetto). The
    profile is yielded for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))


@dataclasses.dataclass
class PhaseStats:
    calls: int = 0
    seconds: float = 0.0
    tokens: int = 0
    audio_seconds: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    @property
    def rtf(self) -> float:
        return self.seconds / self.audio_seconds if self.audio_seconds else 0.0


class PhaseTimer:
    """Wall seconds by phase, on the host clock:

        with timer.phase("decode", tokens=256): ...

    A phase that ends in device work should end in ``sync`` inside the
    block."""

    def __init__(self):
        self.stats: Dict[str, PhaseStats] = defaultdict(PhaseStats)

    @contextlib.contextmanager
    def phase(self, name: str, tokens: int = 0, audio_seconds: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stats[name]
            s.calls += 1
            s.seconds += time.perf_counter() - t0
            s.tokens += tokens
            s.audio_seconds += audio_seconds

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": v.calls, "seconds": round(v.seconds, 4),
                    "tokens_per_s": round(v.tokens_per_s, 1), "rtf": round(v.rtf, 4)}
                for k, v in self.stats.items()}

    def report(self) -> str:
        lines = [f"{'phase':<12} {'calls':>6} {'sec':>9} {'tok/s':>10} {'rtf':>8}"]
        for k, v in self.stats.items():
            lines.append(f"{k:<12} {v.calls:>6} {v.seconds:>9.3f} "
                         f"{v.tokens_per_s:>10.1f} {v.rtf:>8.4f}")
        return "\n".join(lines)


def measure(fn: Callable, *args, iters: int = 3, **kw) -> Dict[str, Any]:
    """{"first_s": the first call, "steady_s": the mean of the next `iters`},
    each timed to the end of its device work (``sync`` of the outputs)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync(out)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    sync(out)
    return {"first_s": first, "steady_s": (time.perf_counter() - t0) / iters}

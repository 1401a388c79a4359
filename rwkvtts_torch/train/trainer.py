"""Training orchestration: step, data, checkpoints (counterpart of
rwkvtts_tpu/train/trainer.py, one device): every task of the JAX
trainer's ``LOSS_FNS``, the low-memory optimizer modes, and frozen
parameters kept out of the optimizer.

The host keeps one step pending: step N's metrics are read (a device
sync) only after step N+1 has been issued, so the host prepares the next
batch while the device still runs the last one.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Callable, Dict, Optional

import torch

from rwkvtts_torch.parallel import train_step as ts
from rwkvtts_torch.train import checkpoint as ckpt_lib
from rwkvtts_torch.train import metrics as metrics_lib
from rwkvtts_torch.train import optimizer as opt_lib

log = logging.getLogger("rwkvtts_torch")


# per-task loss adapters: loss_fn(params, cfg, batch, generator) -> (loss, n_valid)
LOSS_FNS: Dict[str, Callable] = {
    "spark": ts.spark_loss_fn,
    "spark_properties": ts.spark_loss_fn,
    "spark_global": ts.spark_loss_fn,
    "cosy": ts.cosy_loss_fn,
    "xy": ts.xy_loss_fn,
    "asr": ts.asr_loss_fn,
    "tts_two_tower": ts.two_tower_loss_fn,
    "s2s": ts.s2s_loss_fn,
    "sfm_flow": ts.sfm_loss_fn,
}


@dataclasses.dataclass
class TrainerConfig:
    run_dir: str = "runs/default"
    epochs: int = 1
    save_steps: int = 1000
    keep_checkpoints: int = 2
    log_every: int = 10
    peak_lr: float = 1e-4
    final_lr: float = 1e-5
    warmup_steps: int = 1000
    total_steps: int = 100_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # None | "mu_bf16" | "adafactor": the optimizer's moment estimator
    # (train/optimizer.py)
    low_memory_opt: Optional[str] = None
    seed: int = 0
    # a wandb project (and run name) to log the metrics to as well
    wandb_project: Optional[str] = None
    run_name: Optional[str] = None


class Trainer:
    def __init__(self, model_cfg, params, loss_fn: Callable, tcfg: TrainerConfig,
                 device: torch.device):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.optimizer = opt_lib.AdamW(
            params, peak_lr=tcfg.peak_lr, final_lr=tcfg.final_lr,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip,
            low_memory=tcfg.low_memory_opt, frozen=ts.frozen_prefixes(model_cfg),
        )
        self.state = ts.init_train_state(params, self.optimizer)
        self.loss_fn = loss_fn
        self.step_fn = ts.make_train_step(model_cfg, self.optimizer, loss_fn)
        self.logger = metrics_lib.MetricLogger(tcfg.run_dir, tcfg.wandb_project, tcfg.run_name)
        self.throughput = metrics_lib.Throughput()
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.start_epoch = 0
        self.start_batch = 0
        self._preempted = False

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.tcfg.run_dir, "ckpt")

    def to_device(self, batch) -> Dict[str, Any]:
        """A collated numpy batch -> tensors on the trainer's device; the
        '_'-prefixed metadata (S2S's `_is_text`) stays a host value in the
        dict the loss sees."""
        return {k: v if k.startswith("_") else torch.as_tensor(v).to(self.device,
                                                                      non_blocking=True)
                for k, v in batch.items()}

    def maybe_resume(self) -> bool:
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return False
        self.state, meta = ckpt_lib.restore(self.ckpt_dir, self.state, step)
        self.start_epoch = int(meta.get("epoch", 0))
        self.start_batch = int(meta.get("batch", 0))
        log.info("resumed at step %d (epoch %d batch %d)", step, self.start_epoch,
                 self.start_batch)
        return True

    def save(self, epoch: int, batch: int) -> None:
        ckpt_lib.save(self.ckpt_dir, self.state, meta={"epoch": epoch, "batch": batch},
                      keep=self.tcfg.keep_checkpoints)
        log.info("saved checkpoint at step %d", self.state.step)

    def install_preemption_handler(self, signals=None) -> dict:
        """SIGTERM / SIGINT request a checkpoint at the next step boundary,
        then fit() returns; --resume continues from the next batch. Returns
        the handlers it replaced, by signal."""
        import signal as _signal

        def handler(signum, frame):
            log.warning("signal %d: checkpointing at next step boundary", signum)
            self._preempted = True

        return {s: _signal.signal(s, handler)
                for s in signals or (_signal.SIGTERM, _signal.SIGINT)}

    def _drain_metrics(self, pending, all_of_them: bool = False) -> None:
        """Read queued step metrics (a device sync on that step), keeping
        the newest step pending unless `all_of_them`."""
        while pending and (all_of_them or len(pending) > 1):
            pstep, metrics = pending.pop(0)
            n_tok = int(metrics["tokens"])
            kts = self.throughput.update(n_tok)
            if pstep % self.tcfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if kts is not None:
                    m["kt_per_s"] = kts
                self.logger.log(pstep, m, tokens=n_tok)
                if not math.isfinite(m["loss"]):
                    log.warning("non-finite loss %s at step %d", m["loss"], pstep)
                log.info("step %d loss %.4f", pstep, m["loss"])

    def fit(self, dataset) -> ts.TrainState:
        pending: list = []
        for epoch in range(self.start_epoch, self.tcfg.epochs):
            start_batch = self.start_batch if epoch == self.start_epoch else 0
            for bi, batch in enumerate(dataset.epoch(epoch, start_batch), start=start_batch):
                self.state, metrics = self.step_fn(self.state, self.to_device(batch),
                                                   self.generator)
                step = self.state.step
                pending.append((step, metrics))
                self._drain_metrics(pending)
                if self.tcfg.save_steps and step % self.tcfg.save_steps == 0:
                    self.save(epoch, bi + 1)
                if self._preempted:
                    self._drain_metrics(pending, all_of_them=True)
                    self.save(epoch, bi + 1)
                    log.warning("preemption checkpoint saved; exiting fit()")
                    self.logger.close()
                    return self.state
            self._drain_metrics(pending, all_of_them=True)
            self.save(epoch + 1, 0)
        self.logger.close()
        return self.state

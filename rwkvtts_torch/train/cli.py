"""Training CLI of the port (counterpart of rwkvtts_tpu/train/cli.py; the
``spark`` task, one device):

    python -m rwkvtts_torch.train.cli --task spark --data 'data/*.jsonl' \\
        --hidden 1024 --layers 24 --batch-size 8 --pad-to 2048 --run-dir runs/spark

It runs on the CUDA device unless ``--device cpu`` is given; without a
CUDA device and without ``--device cpu`` it raises, and it never moves to
the CPU by itself. The defaults are those of the JAX package on one chip:
bf16 compute over f32 master weights, per-block rematerialisation and the
fused-prep WKV7 kernel pair (``--no-wkv-fuse-prep`` turns it off).
Checkpoints rotate under <run-dir>/ckpt, metrics go to
<run-dir>/metrics.jsonl, and ``--resume`` continues from the newest
checkpoint, mid-epoch data position included.
"""
from __future__ import annotations

import argparse
import functools
import logging
import math
import signal

import torch

from rwkvtts_torch.data import jsonl_dataset
from rwkvtts_torch.train import metrics as metrics_lib
from rwkvtts_torch.train import trainer as trainer_lib

log = logging.getLogger("rwkvtts_torch")


def pick_device(name: str) -> torch.device:
    """The device the caller asked for; a CUDA device that is missing is an
    error, not a reason to run on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train.cli: no CUDA device; pass --device cpu to train on the CPU")
    return dev


def build_model(args, device: torch.device):
    """The Spark config and f32 parameters on `device`, from a
    torch.Generator seeded with --seed."""
    from rwkvtts_torch.models import spark

    cfg = spark.default_config(
        hidden_size=args.hidden, num_layers=args.layers, head_size=args.head_size,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        wkv_fuse_prep=not args.no_wkv_fuse_prep,
    )
    g = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, spark.init_params(g, cfg)


def build_collate(args, model_cfg):
    from rwkvtts_torch.data import spark_collator as sc
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    return functools.partial(sc.collate_plain, tokenizer=get_world_tokenizer(),
                             eos_id=model_cfg.eos_token_id, pad_to=args.pad_to,
                             packed=args.packed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", required=True, choices=sorted(trainer_lib.LOSS_FNS))
    p.add_argument("--data", nargs="+", required=True, help="jsonl glob(s)")
    p.add_argument("--run-dir", default="runs/default")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--head-size", type=int, default=64)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pad-to", type=int, default=2048)
    p.add_argument("--packed", action="store_true")
    p.add_argument("--max-tokens-k", type=int, default=0, help="token budget (thousands)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-final", type=float, default=1e-5)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--total-steps", type=int, default=100_000)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-wkv-fuse-prep", action="store_true",
                   help="keep the elementwise prep outside the WKV kernels")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--dry-run", action="store_true",
                   help="load model and data, run one collated batch through the "
                        "train step, then exit")
    args = p.parse_args(argv)

    metrics_lib.setup_logging()
    device = pick_device(args.device)
    cfg, params = build_model(args, device)
    rows = jsonl_dataset.load_jsonl_rows(args.data, max_rows=args.max_rows)
    log.info("loaded %d rows", len(rows))
    ds = jsonl_dataset.JsonlDataset(
        rows, build_collate(args, cfg), args.batch_size, seed=args.seed,
        max_tokens=args.max_tokens_k * 1000 if args.max_tokens_k else None,
    )
    tcfg = trainer_lib.TrainerConfig(
        run_dir=args.run_dir, epochs=args.epochs, save_steps=args.save_steps,
        log_every=args.log_every, peak_lr=args.lr, final_lr=args.lr_final,
        warmup_steps=args.warmup_steps, total_steps=args.total_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip, seed=args.seed,
    )
    tr = trainer_lib.Trainer(cfg, params, trainer_lib.LOSS_FNS[args.task], tcfg, device)
    if args.dry_run:
        batch = tr.to_device(next(ds.epoch(0)))
        tr.state, m = tr.step_fn(tr.state, batch, tr.generator)
        loss = float(m["loss"])
        log.info("dry run ok: loss=%.4f tokens=%d", loss, int(m["tokens"]))
        if not math.isfinite(loss):
            raise RuntimeError(f"dry run: non-finite loss {loss}")
        return tr
    if args.resume:
        tr.maybe_resume()
    previous = tr.install_preemption_handler()
    try:
        tr.fit(ds)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return tr


if __name__ == "__main__":
    main()

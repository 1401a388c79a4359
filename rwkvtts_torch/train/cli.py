"""Training CLI of the port (counterpart of rwkvtts_tpu/train/cli.py, one
device): every task of the JAX train CLI,

    python -m rwkvtts_torch.train.cli --task spark_properties --data 'data/*.jsonl' \\
        --hidden 1024 --layers 24 --batch-size 4 --pad-to 2048 --run-dir runs/spark

Tasks: spark | spark_properties | spark_global | cosy | xy | asr | s2s |
tts_two_tower | sfm_flow. It runs on the CUDA device unless ``--device
cpu`` is given; without a CUDA device and without ``--device cpu`` it
raises, and it never moves to the CPU by itself. The defaults are those of
the JAX package on one chip: bf16 compute over f32 master weights,
per-block rematerialisation and the fused-prep WKV7 kernel pair
(``--no-wkv-fuse-prep`` turns it off); the ASR model's Whisper encoder
stays frozen, out of the optimizer. ``--low-memory-opt`` picks the
optimizer's moment estimator, ``--warm-start`` seeds a Spark model from a
text RWKV-7 checkpoint. Checkpoints rotate under <run-dir>/ckpt, metrics
go to <run-dir>/metrics.jsonl, and ``--resume`` continues from the newest
checkpoint, mid-epoch data position included.

``--mark-phonemes-prob`` marks the spark_properties task's texts with
their pronunciation (``text_frontend.mark_phonemes``), the draws from one
``random.Random(--seed)`` kept across batches; another task refuses it
(the JAX CLI ignores it there).

``--data-format webdataset`` reads the rows from tars (``--data`` globs of
plain ``.tar`` shards; ``data/webdataset.MultipleWebDataset`` through the
C++ tar streamer, shuffled with --seed, ``--max-rows`` of them). ``--codec-dir`` (a Spark-TTS model
directory: BiCodec/ and wav2vec2-large-xlsr-53/) tokenizes the tars' audio
with BiCodec on the device as each batch is collated, in front of the
task's own collator and tokenizer (``data/inline_spark.py``): spark,
spark_properties (with its phoneme marking) or spark_global. Another task
refuses --codec-dir, and so does the jsonl format; the JAX CLI ignores the
flag there, and on tars puts the plain collator and a tokenizer without
the SPCT tokens in front of every Spark task.

    python -m rwkvtts_torch.train.cli --task spark --data-format webdataset \\
        --data 'shards/*.tar' --codec-dir Spark-TTS-0.5B --hidden 1024 --layers 24

``--wandb-project`` / ``--run-name`` also log the metrics to wandb; asking
for it without the package installed raises.

``--remat-policy`` picks what each block's backward replay may keep
(``rwkv7.RWKV7Config.remat_policy``): by default nothing (the whole block
is replayed), ``wkv`` the WKV call (the replay never runs the forward WKV
kernel: at Spark 1024 x 24 a step launches kernels 4 / 5 24 / 24 times,
not 48 / 24), ``dots`` / ``dots_no_batch`` the matrix products' outputs.

Several GPUs: run it under ``torchrun``, which starts a process a rank and
gives each the env:// rendezvous; every rank takes ``--batch-size`` as the
global batch and trains its part of it on a device mesh (parallel/mesh.py):

    torchrun --nproc-per-node 4 -m rwkvtts_torch.train.cli --task spark \
        --data 'data/*.jsonl' --mesh dp=2,fsdp=2 --batch-size 16 ...

``--mesh dp=..,fsdp=..,sp=..`` is the mesh (default: every rank on dp); its
product must be the number of ranks. fsdp shards the f32 masters and the
optimizer state; sp splits the time axis (the spark tasks), sets
``--wkv-spans`` to sp when it is not given (a multiple of sp otherwise) and
turns the fused prep off, and ``--pad-to`` must divide by it. tp is refused
(not ported yet). ``--wkv-spans`` alone runs the WKV recurrence in that
many spans on one device. The process group is initialised whenever
torchrun's ``WORLD_SIZE`` is > 1 (or ``--mesh`` is given under torchrun):
NCCL on CUDA, each rank on its ``LOCAL_RANK``'s card, gloo on the CPU;
``--dist-backend gloo --device cuda:0`` puts every rank on one card (a test
setting: NCCL takes one rank a card). ``--multihost`` asserts torchrun's
environment (a multi-node torchrun gives it) and refuses to start without
it. ``--no-layer-unroll`` and ``--wkv-mm`` are TPU layout and precision
devices without a counterpart.
"""
from __future__ import annotations

import argparse
import datetime
import functools
import glob
import importlib
import logging
import math
import os
import random
import signal
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from rwkvtts_torch.data import jsonl_dataset
from rwkvtts_torch.train import metrics as metrics_lib
from rwkvtts_torch.train import trainer as trainer_lib

log = logging.getLogger("rwkvtts_torch")


def parse_mesh(text: str) -> Dict[str, int]:
    """--mesh "dp=2,fsdp=2" -> {"dp": 2, "fsdp": 2}; ValueError on an
    unknown axis or a size that is not a positive integer."""
    shape = {}
    for kv in text.split(","):
        key, _, val = kv.partition("=")
        if key not in ("dp", "fsdp", "tp", "sp"):
            raise ValueError(f"--mesh: unknown axis {key!r} (dp, fsdp, tp, sp)")
        if not val.isdigit() or int(val) < 1:
            raise ValueError(f"--mesh: {key}={val!r} is not a positive integer")
        shape[key] = int(val)
    return shape


# a collective that waits longer than this fails the run instead of hanging it
DIST_TIMEOUT = datetime.timedelta(seconds=600)


def init_distributed(args) -> bool:
    """Join the process group from torchrun's env:// rendezvous when
    WORLD_SIZE > 1 (or --mesh is given under torchrun), with
    ``DIST_TIMEOUT``; returns whether this call initialised it (its caller
    then destroys it). A group initialised before (parallel/dryrun.cli_rank's
    file:// store) is joined as it is. NCCL on CUDA (each rank on its
    LOCAL_RANK's card, set first), gloo on the CPU or when --dist-backend
    asks for it."""
    if "WORLD_SIZE" not in os.environ:
        if args.multihost:
            raise SystemExit("--multihost runs under torchrun: WORLD_SIZE, RANK, MASTER_ADDR "
                             "and MASTER_PORT are not set")
        if args.mesh:
            raise SystemExit("--mesh runs under torchrun (torchrun --nproc-per-node N -m "
                             "rwkvtts_torch.train.cli ...)")
        return False
    if int(os.environ["WORLD_SIZE"]) == 1 and not args.mesh:
        return False
    dev = torch.device(args.device)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise SystemExit("--dist-backend nccl needs a CUDA device")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        pick_device(str(dev))
        torch.cuda.set_device(dev)
        args.device = str(dev)
    mine = not dist.is_initialized()
    if mine:
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=DIST_TIMEOUT,
                                **kw)
    if dist.get_rank() != 0:
        logging.getLogger().setLevel(logging.WARNING)
    return mine


def rank_rows(collate: Callable, mesh) -> Callable:
    """A collator of this rank's rows of each global batch only (the
    --codec-dir path: the inline tokenization then runs on them alone); a
    batch that the mesh's dp x fsdp does not divide raises."""

    def fn(rows):
        if len(rows) % mesh.rows:
            raise ValueError(f"a batch of {len(rows)} rows: not divisible by dp x fsdp = "
                             f"{mesh.rows}")
        b = len(rows) // mesh.rows
        return collate(rows[mesh.row_part * b:(mesh.row_part + 1) * b])

    return fn


def pick_device(name: str) -> torch.device:
    """The device the caller asked for; a CUDA device that is missing is an
    error, not a reason to run on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train.cli: no CUDA device; pass --device cpu to train on the CPU")
    return dev


def build_model(task: str, args, device: torch.device):
    """The task's config and f32 parameters on `device`, from a
    torch.Generator seeded with --seed. The RWKV options (head size, the
    fused prep, the remat policy) reach every RWKV stack of the model,
    both towers of asr and tts_two_tower included."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    rwkv = dict(head_size=args.head_size, wkv_fuse_prep=not args.no_wkv_fuse_prep,
                remat_policy=getattr(args, "remat_policy", None),
                wkv_spans=getattr(args, "wkv_spans", None) or 1)
    kw = dict(hidden_size=args.hidden, num_layers=args.layers, dtype=dtype, **rwkv)
    g = torch.Generator(device=device).manual_seed(args.seed)
    if task == "sfm_flow":
        from rwkvtts_torch.codecs import flow as mod

        cfg = mod.FlowConfig(sfm=True)
    elif task == "tts_two_tower":
        from rwkvtts_torch.models import tts_two_tower as mod

        cfg = mod.default_config(text_hidden=args.hidden, text_layers=args.layers,
                                 audio_hidden=args.hidden, audio_layers=args.layers,
                                 dtype=dtype, **rwkv)
    else:  # spark*, cosy, xy, asr, s2s: the model module of that name
        mod = importlib.import_module(
            f"rwkvtts_torch.models.{'spark' if task.startswith('spark') else task}")
        cfg = mod.default_config(**kw)
    return cfg, mod.init_params(g, cfg)


def build_collate(task: str, args, model_cfg) -> Callable:
    """The task's jsonl collator. Cosy's prompt-drop coin comes from one
    numpy generator seeded with --seed, spark_properties' phoneme marking
    from one ``random.Random(--seed)`` (with --seed 0 the JAX CLI's
    module-level ``Random(0)`` in a fresh process); S2S batches alternate
    audio and text, the first one audio, as the JAX CLI's toggle does."""
    from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

    tok = get_world_tokenizer(n_spct=64 if task in ("spark_properties", "spark_global") else 0)
    if task.startswith("spark"):
        from rwkvtts_torch.data import spark_collator as sc

        fn = {"spark": sc.collate_plain, "spark_properties": sc.collate_with_properties,
              "spark_global": sc.collate_global_tokens}[task]
        kw = {}
        if task == "spark_properties" and getattr(args, "mark_phonemes_prob", 0.0) > 0:
            kw = dict(mark_phonemes_prob=args.mark_phonemes_prob, rng=random.Random(args.seed))
        return functools.partial(fn, tokenizer=tok, eos_id=model_cfg.eos_token_id,
                                 pad_to=args.pad_to, packed=args.packed, **kw)
    if task == "cosy":
        from rwkvtts_torch.data import cosy_collator as cc

        return functools.partial(cc.collate, tokenizer=tok, eos_id=model_cfg.eos_token_id,
                                 rng=np.random.default_rng(args.seed),
                                 drop_prompt_audio_rate=args.drop_prompt_audio_rate,
                                 pad_to=args.pad_to, packed=args.packed)
    if task == "xy":
        from rwkvtts_torch.data import xy_collator as xc
        from rwkvtts_torch.infer.xy_pipeline import xy_text_tokenizer

        # the [S0] / [CTL0] markers as the XY LM's added tokens
        return functools.partial(xc.collate, tokenizer=xy_text_tokenizer(), pad_to=args.pad_to)
    if task == "asr":
        from rwkvtts_torch.data import asr_collator as ac

        return functools.partial(ac.collate, tokenizer=tok, n_mels=model_cfg.whisper.n_mels)
    if task == "sfm_flow":
        from rwkvtts_torch.data import sfm_collator as sfc

        return functools.partial(sfc.collate, pad_tokens_to=args.pad_to)
    if task == "s2s":
        from rwkvtts_torch.data import s2s_collator as s2c

        state = {"text": True}

        def alternating(rows):
            state["text"] = not state["text"]
            return s2c.collate_s2s(rows, tok, is_text=state["text"], pad_to=args.pad_to,
                                   text_vocab=model_cfg.text_vocab_size)

        return alternating
    if task == "tts_two_tower":
        from rwkvtts_torch.data import s2s_collator as s2c

        return functools.partial(s2c.collate_two_tower, tokenizer=tok, pad_audio_to=args.pad_to)
    raise ValueError(f"no jsonl collator for task {task}")


def load_rows(args) -> list:
    """--data's rows: jsonl lines, or the samples of the tars its globs
    name (sorted within each glob), shuffled with --seed."""
    if args.data_format == "jsonl":
        return jsonl_dataset.load_jsonl_rows(args.data, max_rows=args.max_rows)
    from rwkvtts_torch.data import webdataset

    tars = [p for pat in args.data for p in sorted(glob.glob(pat))]
    rows = webdataset.MultipleWebDataset(tars, seed=args.seed).samples
    return rows[: args.max_rows] if args.max_rows else rows


def inline_codec(codec_dir: str, device: torch.device):
    """--codec-dir's BiCodec and wav2vec2 frontend on `device`."""
    from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer

    return SparkAudioTokenizer.from_pretrained(codec_dir, device=device)


def warm_start(task: str, path: str, params, cfg, device: torch.device):
    """--warm-start: a Spark task's model seeded from a text RWKV-7
    checkpoint (``convert/speech_init.spark_from_text``); other tasks keep
    their fresh weights, with the JAX CLI's warning."""
    from rwkvtts_torch import bridge
    from rwkvtts_torch.convert import rwkv7_ckpt, speech_init

    if not task.startswith("spark"):
        log.warning("warm-start surgery only wired for spark tasks here")
        return params
    sd = rwkv7_ckpt.load_torch_or_safetensors(path)
    return bridge.params_from_numpy(speech_init.spark_from_text(sd, params, cfg), device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", required=True, choices=sorted(trainer_lib.LOSS_FNS))
    p.add_argument("--data", nargs="+", required=True,
                   help="jsonl glob(s), or tar glob(s) with --data-format webdataset")
    p.add_argument("--data-format", choices=["jsonl", "webdataset"], default="jsonl")
    p.add_argument("--codec-dir", default=None,
                   help="Spark-TTS model dir: tokenize the tars' audio inline "
                        "(spark tasks, --data-format webdataset)")
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
    p.add_argument("--low-memory-opt", choices=["mu_bf16", "adafactor"], default=None,
                   help="the optimizer's moment estimator: bf16 first moment, or "
                        "factored second moment without a first (train/optimizer.py)")
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-wkv-fuse-prep", action="store_true",
                   help="keep the elementwise prep outside the WKV kernels")
    p.add_argument("--remat-policy", default=None, choices=["wkv", "dots", "dots_no_batch"],
                   help="what a block's backward replay keeps (default: nothing, the whole "
                        "block is replayed); wkv: the WKV call, dots: matrix products")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--warm-start", default=None,
                   help="text RWKV-7 checkpoint to seed a spark task's model from")
    p.add_argument("--drop-prompt-audio-rate", type=float, default=0.5,
                   help="cosy: the probability that a batch drops its prompts")
    p.add_argument("--mark-phonemes-prob", type=float, default=0.0,
                   help="spark_properties: the probability that a row's text is marked "
                        "with its pronunciation")
    p.add_argument("--wandb-project", default=None,
                   help="also log the metrics to this wandb project")
    p.add_argument("--run-name", default=None)
    p.add_argument("--max-rows", type=int, default=None)
    p.add_argument("--dry-run", action="store_true",
                   help="load model and data, run one collated batch through the "
                        "train step, then exit")
    p.add_argument("--mesh", default=None,
                   help="device mesh over the torchrun ranks, e.g. dp=2,fsdp=2 or dp=2,sp=2 "
                        "(default: every rank on dp); sp splits the time axis")
    p.add_argument("--wkv-spans", type=int, default=None,
                   help="the WKV recurrence in this many spans (default 1; sp with --mesh sp)")
    p.add_argument("--multihost", action="store_true",
                   help="a multi-node torchrun: refuse to start without its environment")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on CUDA, gloo on the CPU")
    args = p.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = parse_mesh(args.mesh)
        except ValueError as e:
            p.error(str(e))
        if mesh_shape.get("tp", 1) > 1:
            p.error("--mesh tp: tensor parallelism is not ported yet")
        sp = mesh_shape.get("sp", 1)
        if sp > 1:
            if not args.task.startswith("spark"):
                p.error(f"--mesh sp splits the time axis of the spark tasks; --task {args.task} "
                        "has inputs of other lengths")
            if args.wkv_spans is None:
                args.wkv_spans = sp
            elif args.wkv_spans % sp:
                p.error(f"--wkv-spans {args.wkv_spans} must be a multiple of the mesh sp={sp}")
            if args.pad_to % sp:
                p.error(f"--pad-to {args.pad_to} must divide by the mesh sp={sp}")
            args.no_wkv_fuse_prep = True
    # the mesh the trainer builds: --mesh, or every torchrun rank on dp
    shape = mesh_shape or {"dp": int(os.environ.get("WORLD_SIZE", "1"))}
    rows = shape.get("dp", 1) * shape.get("fsdp", 1)
    if args.batch_size % rows:
        p.error(f"--batch-size {args.batch_size} (the global batch) must divide by "
                f"dp x fsdp = {rows}")
    if args.max_tokens_k and rows > 1:
        p.error("--max-tokens-k shrinks batches below --batch-size: not with dp x fsdp > 1")
    if args.mark_phonemes_prob > 0 and args.task != "spark_properties":
        p.error("--mark-phonemes-prob marks the texts of --task spark_properties only")
    if args.codec_dir and not args.task.startswith("spark"):
        p.error(f"--codec-dir tokenizes audio with BiCodec for the spark tasks; "
                f"--task {args.task} has no inline codec")
    if args.codec_dir and args.data_format != "webdataset":
        p.error("--codec-dir tokenizes the audio of tars: it needs --data-format webdataset")

    metrics_lib.setup_logging()
    mine = init_distributed(args)
    try:
        return _run(args, mesh_shape)
    finally:
        if mine:
            dist.destroy_process_group()


def _run(args, mesh_shape):
    device = pick_device(args.device)
    cfg, params = build_model(args.task, args, device)
    if args.warm_start:
        params = warm_start(args.task, args.warm_start, params, cfg, device)
    rows = load_rows(args)
    log.info("loaded %d rows", len(rows))
    tcfg = trainer_lib.TrainerConfig(
        run_dir=args.run_dir, epochs=args.epochs, save_steps=args.save_steps,
        log_every=args.log_every, peak_lr=args.lr, final_lr=args.lr_final,
        warmup_steps=args.warmup_steps, total_steps=args.total_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        low_memory_opt=args.low_memory_opt, seed=args.seed,
        wandb_project=args.wandb_project, run_name=args.run_name, mesh_shape=mesh_shape,
    )
    tr = trainer_lib.Trainer(cfg, params, trainer_lib.LOSS_FNS[args.task], tcfg, device)
    collate = build_collate(args.task, args, cfg)
    if args.codec_dir:
        from rwkvtts_torch.data import inline_spark

        collate = rank_rows(inline_spark.inline_collate(collate, inline_codec(args.codec_dir,
                                                                                device)), tr.mesh)
    ds = jsonl_dataset.JsonlDataset(
        rows, collate, args.batch_size, seed=args.seed,
        max_tokens=args.max_tokens_k * 1000 if args.max_tokens_k else None,
    )
    rows_local = bool(args.codec_dir)
    if args.dry_run:
        batch = tr.to_device(next(ds.epoch(0)), rows_local)
        tr.state, m = tr.step_fn(tr.state, batch, tr.generator)
        tr.dry_run_metrics = {k: float(v) for k, v in m.items()}
        loss = float(m["loss"])
        log.info("dry run ok: loss=%.4f tokens=%d", loss, int(m["tokens"]))
        if not math.isfinite(loss):
            raise RuntimeError(f"dry run: non-finite loss {loss}")
        return tr
    if args.resume:
        tr.maybe_resume()
    previous = tr.install_preemption_handler()
    try:
        tr.fit(ds, rows_local)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return tr


if __name__ == "__main__":
    main()

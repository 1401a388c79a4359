"""A mesh's train step, one process a rank (the counterpart of
``__graft_entry__.dryrun_multichip``): the CPU tests spawn it with
``torch.multiprocessing.spawn`` over gloo, and ``torchrun`` drives it
through ``python -m rwkvtts_torch.parallel.dryrun SPEC OUT_DIR`` (a pickled
spec; RANK / WORLD_SIZE from torchrun's environment). ``python -m
rwkvtts_torch.parallel.dryrun --cli OUT_DIR ARGS...`` runs train/cli.py's
main on a torchrun rank instead and writes what the rank saw
(``_cli_run``).

``run_rank(rank, world, spec, out_dir)`` joins the process group, builds
the mesh, shards the given f32 parameters and the optimizer state, takes
the rank's part of the global batch and runs ``spec["steps"]`` train steps;
rank 0 then writes ``out_dir/result.pt``: each step's metrics, the
post-step parameters and optimizer state gathered whole, and every rank's
kernel launches (and, on a card, the step's milliseconds). The spec keys:

  cfg, task          the model config and the trainer task (its loss)
  params, batch      {path: numpy} f32 parameters, {key: numpy} global batch
  mesh               {"dp": .., "fsdp": .., "sp": ..}
  optimizer          AdamW keyword arguments
  device, backend    "cpu" / "cuda:0" ..., "gloo" / "nccl"
  init_method        "file://..." (default "env://"), timeout (seconds)
  steps              train steps (default 1)
  save, restore      a checkpoint directory to write after the steps / to
                     resume from before them (train/checkpoint.py)
  deterministic      torch.use_deterministic_algorithms (warn only)
  time_collectives   time every collective (mesh.timing)

Everything here imports torch and the port only: spawned children unpickle
``run_rank`` by its module path.
"""
from __future__ import annotations

import datetime
import json
import os
import pickle
import sys
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist


def _launch_counts() -> Dict[str, int]:
    from rwkvtts_torch.ops import wkv7_cuda

    return dict(wkv7_cuda.launches)


def run_rank(rank: int, world: int, spec: Dict[str, Any], out_dir: str) -> None:
    from rwkvtts_torch.ops import wkv7_cuda
    from rwkvtts_torch.parallel import mesh as mesh_lib
    from rwkvtts_torch.parallel import train_step as ts
    from rwkvtts_torch.train import checkpoint as ckpt_lib
    from rwkvtts_torch.train import optimizer as opt_lib
    from rwkvtts_torch.train import trainer as trainer_lib

    torch.set_num_threads(spec.get("threads", 1))
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    mesh_lib.timing.update(on=bool(spec.get("time_collectives")), s=0.0, calls=0)
    device = torch.device(spec.get("device", "cpu"))
    backend = spec.get("backend", "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=spec.get("init_method", "env://"), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=spec.get("timeout", 120)), **kw)
    try:
        cfg = spec["cfg"]
        params = opt_lib.unflatten({p: torch.as_tensor(np.asarray(v)).to(device)
                                    for p, v in spec["params"].items()})
        optimizer = opt_lib.AdamW(params, **spec.get("optimizer", {}),
                                  frozen=ts.frozen_prefixes(cfg))
        mesh = mesh_lib.make_mesh(**spec["mesh"], device_type=device.type, device=device)
        optimizer.shard(mesh, mesh.layout(params, optimizer.labels))
        state = ts.shard_state(ts.init_train_state(params, optimizer), optimizer, mesh)
        if spec.get("restore"):
            state, _ = ckpt_lib.restore(spec["restore"], state, mesh=mesh, optimizer=optimizer)
        step = ts.make_train_step(cfg, optimizer, trainer_lib.LOSS_FNS[spec["task"]], mesh=mesh)
        local = mesh.local_batch(spec["batch"])
        batch = {k: v if k.startswith("_") else torch.as_tensor(np.asarray(v)).to(device)
                 for k, v in local.items()}
        metrics, ms = [], []
        wkv7_cuda.reset_launches()
        for _ in range(spec.get("steps", 1)):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, m = step(state, batch, None)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = _launch_counts()
        if spec.get("save"):
            ckpt_lib.save(spec["save"], state, mesh=mesh, optimizer=optimizer)
        whole = ts.gather_state(state, optimizer, mesh)
        every = [None] * world
        dist.all_gather_object(every, {"rank": rank, "launches": launches, "ms": ms,
                                       "collective_s": mesh_lib.timing["s"],
                                       "collectives": mesh_lib.timing["calls"]})
        if rank == 0:
            cpu = lambda t: t.detach().cpu()
            result = {
                "metrics": metrics,
                "params": {p: cpu(t) for p, t in opt_lib.flatten(whole.params).items()},
                "opt_state": {k: ({p: cpu(t) for p, t in v.items()} if isinstance(v, dict)
                                  else cpu(v)) for k, v in whole.opt_state.items()},
                "ranks": every,
                "layout": optimizer.layout,
            }
            os.makedirs(out_dir, exist_ok=True)
            torch.save(result, os.path.join(out_dir, "result.pt"))
    finally:
        dist.destroy_process_group()


def _run_spec_file(rank: int, world: int, spec_path: str, out_dir: str) -> None:
    """``run_rank`` on the pickled spec, or on each (spec, out_dir) of a
    pickled list in turn."""
    with open(spec_path, "rb") as f:
        specs = pickle.load(f)
    for spec, out in specs if isinstance(specs, list) else [(specs, out_dir)]:
        run_rank(rank, world, spec, out)


def spawn(world: int, spec, out_dir: str):
    """Run `world` ranks of ``run_rank`` as spawned processes (a rank that
    fails fails the call); rank 0's result. `spec` may be a list of (spec,
    out_dir) pairs that the same processes run in turn; then a list of
    results. The spec goes through a file: the children then start side by
    side (a spawn blocks on a child that unpickles large arguments)."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    mp.spawn(_run_spec_file, args=(world, spec_path, out_dir), nprocs=world, join=True)
    load = lambda d: torch.load(os.path.join(d, "result.pt"), weights_only=False)
    return [load(d) for _, d in spec] if isinstance(spec, list) else load(out_dir)


def cli_rank(rank: int, world: int, argv, out_dir: str, init_method: str) -> None:
    """One spawned rank of ``train.cli.main(argv)`` with torchrun's
    environment set, its gloo group joined here through `init_method` (a
    file:// store), which the CLI then uses; see ``_cli_run``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from rwkvtts_torch.train import cli

    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=cli.DIST_TIMEOUT)
    try:
        _cli_run(list(argv), out_dir)
    finally:
        dist.destroy_process_group()


def _cli_run(argv, out_dir: str) -> None:
    """``train.cli.main(argv)`` on this rank, its collectives timed
    (mesh.timing), its checkpoints skipped if argv starts with --no-save;
    writes out_dir/cli_rank<RANK>.json: the train state's
    step, the mesh, the dry run's metrics, the parameter shard shapes, the
    kernel launches, the seconds in collectives and the device's peak
    memory."""
    from rwkvtts_torch.parallel import mesh as mesh_lib
    from rwkvtts_torch.train import cli
    from rwkvtts_torch.train import optimizer as opt_lib

    mesh_lib.timing.update(on=True, s=0.0, calls=0)
    if argv[0] == "--no-save":  # the run's checkpoints are not written
        from rwkvtts_torch.train import trainer

        trainer.Trainer.save = lambda self, epoch, batch: None
        argv = argv[1:]
    tr = cli.main(argv)
    cuda = tr.device.type == "cuda"
    out = {"step": tr.state.step, "mesh": tr.mesh.shape,
           "metrics": getattr(tr, "dry_run_metrics", None),
           "shapes": {p: list(t.shape) for p, t in opt_lib.flatten(tr.state.params).items()},
           "launches": _launch_counts(), "collective_s": mesh_lib.timing["s"],
           "collectives": mesh_lib.timing["calls"],
           "peak_bytes": torch.cuda.max_memory_allocated(tr.device) if cuda else None}
    with open(os.path.join(out_dir, f"cli_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)


def main(argv=None) -> None:
    argv = list(argv or sys.argv[1:])
    if argv[0] == "--cli":  # OUT_DIR, then train.cli's arguments
        os.makedirs(argv[1], exist_ok=True)
        _cli_run(argv[2:], argv[1])
        return
    spec_path, out_dir = argv[:2]
    _run_spec_file(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), spec_path, out_dir)
    if int(os.environ["RANK"]) == 0:
        res = torch.load(os.path.join(out_dir, "result.pt"), weights_only=False)
        print(json.dumps({"metrics": res["metrics"], "ranks": res["ranks"]}), flush=True)


if __name__ == "__main__":
    main()

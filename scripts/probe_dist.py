"""Which collectives gloo takes on CUDA tensors, on one card: two gloo ranks
on cuda:0 (spawned) try all_reduce (f32, int64, bf16), all_gather_into_tensor
(f32, bf16), all_gather, reduce_scatter_tensor, broadcast, barrier and
send / recv on CUDA and on CPU tensors (send / recv last: a refused one
breaks the pair for what follows); then one NCCL rank with a device mesh.
Prints "ok" or the error of each.

    python3 scripts/probe_dist.py   # needs a CUDA device
"""
import os
import sys
import tempfile
import traceback
import datetime

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def ops(dev, rank, world):
    out = {}
    def t(name, fn):
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:
            out[name] = f"FAIL {type(e).__name__}: {str(e)[:160]}"
    x = torch.full((4, 3), float(rank + 1), device=dev)
    t("all_reduce", lambda: dist.all_reduce(x))
    t("all_reduce_i64", lambda: dist.all_reduce(torch.ones(1, dtype=torch.int64, device=dev)))
    t("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(4 * world, 3, device=dev), torch.ones(4, 3, device=dev)))
    t("all_gather_list", lambda: dist.all_gather(
        [torch.empty(4, 3, device=dev) for _ in range(world)], torch.ones(4, 3, device=dev)))
    t("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(2, 3, device=dev), torch.ones(2 * world, 3, device=dev)))
    t("broadcast", lambda: dist.broadcast(torch.ones(3, device=dev), 0))
    t("all_reduce_bf16", lambda: dist.all_reduce(torch.ones(3, dtype=torch.bfloat16, device=dev)))
    t("all_gather_into_tensor_bf16", lambda: dist.all_gather_into_tensor(
        torch.empty(4 * world, dtype=torch.bfloat16, device=dev), torch.ones(4, dtype=torch.bfloat16, device=dev)))
    t("barrier", lambda: dist.barrier())

    def sr():
        y = torch.ones(3, device=dev)
        if rank == 0:
            dist.send(y, 1)
        else:
            dist.recv(y, 0)

    if world > 1:
        t("send_recv", sr)
    return out


def worker(rank, world, store):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    res = {"cpu": ops(torch.device("cpu"), rank, world), "cuda": ops(torch.device("cuda", 0), rank, world)}
    try:
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names=("dp", "fsdp", "tp"))
        g = m.get_group("dp")
        y = torch.ones(2, device="cuda")
        dist.all_reduce(y, group=g)
        res["mesh_cpu_type_cuda_tensor"] = str(y.tolist())
    except Exception:
        res["mesh"] = traceback.format_exc()[-400:]
    try:
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cuda", (2, 1), mesh_dim_names=("dp", "fsdp"))
        res["mesh_cuda_gloo"] = "ok " + str(m)
    except Exception:
        res["mesh_cuda_gloo"] = traceback.format_exc()[-400:]
    if rank == 0:
        import json
        print("GLOO", json.dumps(res, indent=1), flush=True)
    dist.destroy_process_group()


def nccl_one(store):
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60), device_id=torch.device("cuda", 0))
    res = ops(torch.device("cuda", 0), 0, 1)
    from torch.distributed.device_mesh import init_device_mesh
    m = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("dp", "fsdp", "tp"))
    x = torch.ones(3, device="cuda")
    dist.all_reduce(x, group=m.get_group("fsdp"))
    res["mesh_group_all_reduce"] = str(x.tolist())
    print("NCCL", res, flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    d = tempfile.mkdtemp()
    mp.spawn(worker, args=(2, os.path.join(d, "s1")), nprocs=2, join=True)
    nccl_one(os.path.join(d, "s2"))
    print("probe done", flush=True)

"""How the dp slot pool's groups go with their dispatch, on one card: the
Spark pool of chip_smoke.py's phase 46 (1024 x 24, bf16 matrices, the
decode-packed tree, 96 slots, chunk 32, greedy) as 1 group, and as 2 groups
on cuda:0 whose chunk is issued from one host thread (the pool's own
``_chunk``, one group after the other) or from a thread a group. Prints ms a
pool step of each: ROUNDS chunks each, in turns, and their median. Groups
on one card share its stream: not a multi-GPU number.

    python3 scripts/probe_dp_threads.py   # needs a CUDA device
"""
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

ROUNDS = 3


def main() -> None:
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.serving.continuous import ContinuousBatcher

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = spark.default_config(hidden_size=cs.SERVE_HIDDEN, num_layers=cs.SERVE_LAYERS,
                               decode_wkv_packed=True)
    params = cs._bf16_matrices(spark.init_params(torch.Generator(device=dev).manual_seed(3), cfg))
    packed = rwkv7.pack_decode_params(params, cfg.backbone)
    prompts = cs.serve_prompts(cs.SERVE_SLOTS, 41)
    pools = {}
    for n in (1, 2):
        cb = ContinuousBatcher(packed, cfg, n_slots=cs.SERVE_SLOTS, chunk=cs.SERVE_CHUNK,
                               devices=[dev] * n if n > 1 else None)
        cb.warmup()
        for i, (pb, _) in enumerate(prompts):
            cb.add_request(pb, 1 << 20, seed=i)
        with torch.inference_mode():
            cb._admit()
        pools[n] = cb
    workers = concurrent.futures.ThreadPoolExecutor(2)

    def group_chunk(g):
        # inference mode and the current device are a thread's own
        with torch.inference_mode(), torch.cuda.device(g.device):
            return g._chunk()

    def threaded():
        return [f.result() for f in [workers.submit(group_chunk, g) for g in pools[2]._groups]]

    variants = {"1 group": (pools[1], pools[1]._chunk),
                "2 groups, one thread": (pools[2], pools[2]._chunk),
                "2 groups, a thread a group": (pools[2], threaded)}
    ms = {k: [] for k in variants}
    with torch.inference_mode():
        for _ in range(ROUNDS):
            for name, (cb, dispatch) in variants.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                cb._to_host(dispatch())
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - t) / cs.SERVE_CHUNK)
    workers.shutdown()
    out = {k: {"median": statistics.median(v), "runs": v} for k, v in ms.items()}
    print(f"dp threads: ms a pool step, Spark {cs.SERVE_HIDDEN} x {cs.SERVE_LAYERS}, "
          f"{cs.SERVE_SLOTS} slots, groups sharing one card (not a multi-GPU number), on {card}")
    print("dp threads: " + json.dumps(out))


if __name__ == "__main__":
    main()

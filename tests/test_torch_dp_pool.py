"""The dp slot pool of the port (serving/continuous.ContinuousBatcher with
``devices``) on the CPU: four groups on ``["cpu"] * 4`` give the tokens of
the JAX package's pool on a dp=4 mesh and of the port's one-group pool
(tests/test_continuous.py's dp case), greedy and sampled, with and without
overlap, admissions landing in every group; the refusals; a service with
dp groups."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.parallel import mesh as jmesh
from rwkvtts_tpu.serving import continuous as jcont
from rwkvtts_torch import bridge
from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
from rwkvtts_torch.models import rwkv7 as trwkv7
from rwkvtts_torch.models import spark as tspark
from rwkvtts_torch.serving import continuous as tcont
from rwkvtts_torch.serving import launch
from rwkvtts_torch.serving import service as tsvc

from test_torch_serving import FakeTok, _prompt

torch.set_num_threads(2)

TEXTS = [f"sharded pool req {i}" for i in range(6)]
MAX_NEW = 10


@pytest.fixture(scope="module")
def model():
    """tests/test_continuous.py's dp pool model: Spark 32 x 2, head 8, f32;
    JAX's params and config, the port's config and the same numbers."""
    jcfg = jspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                 dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0)
    jparams = jax.jit(jspark.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tcfg = tspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                 dtype=torch.float32, decode_wkv_packed=True)
    return jcfg, jparams, tcfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))


def _run(pool, seeds=None):
    rids = {pool.add_request(_prompt(t), MAX_NEW,
                             **({} if seeds is None else {"seed": seeds[i]})): i
            for i, t in enumerate(TEXTS)}
    return {rids[r]: list(t) for r, t in pool.drain().items()}


def test_dp_groups_give_the_tokens_of_jax_dp_pool_and_one_group(model):
    """Greedy: 4 groups of 1 slot (6 requests: admissions into every group,
    slots reused) = JAX's pool on a dp=4 mesh = the port's one-group pool,
    also in overlap mode; each group holds its own parameters and a
    quarter of the carry. Sampled (temperature 1, top-k 20, per-request
    seeds): 4 groups = 1 group."""
    jcfg, jparams, tcfg, tparams = model
    packed = trwkv7.pack_decode_params(tparams, tcfg.backbone)
    kw = dict(n_slots=4, chunk=4, prompt_cap=32, top_k=1)
    mesh = jmesh.make_mesh(dp=4)
    jpool = jcont.ContinuousBatcher(jparams, jcfg, mesh=mesh, **kw)
    want = {}
    rids = {jpool.add_request(_prompt(t, FakeTok()), MAX_NEW): i for i, t in enumerate(TEXTS)}
    for r, toks in jpool.drain().items():
        want[rids[r]] = list(toks)
    one = _run(tcont.ContinuousBatcher(packed, tcfg, **kw))
    dp = tcont.ContinuousBatcher(packed, tcfg, devices=["cpu"] * 4, **kw)
    assert len(dp._groups) == 4 and all(g.n_slots == 1 for g in dp._groups)
    assert dp._groups[1].params is not dp._groups[0].params
    assert _run(dp) == one == want
    assert dp.stats["admitted"] == len(TEXTS)
    assert _run(tcont.ContinuousBatcher(packed, tcfg, devices=["cpu"] * 4, overlap=True,
                                        **kw)) == want
    warmed = tcont.ContinuousBatcher(packed, tcfg, devices=["cpu"] * 2, **kw)
    warmed.warmup([32])
    assert _run(warmed) == want

    skw = dict(kw, top_k=20, temperature=1.0)
    seeds = [11, 12, 13, 14, 15, 16]
    sampled = _run(tcont.ContinuousBatcher(packed, tcfg, devices=["cpu"] * 4, **skw), seeds)
    assert sampled == _run(tcont.ContinuousBatcher(packed, tcfg, **skw), seeds)
    assert sampled != want


def test_dp_refusals_and_service(model):
    """Slots that dp does not divide, the megakernel pool with groups, more
    cards than present, and the launcher's --dp with the Cosy family,
    --grouped or --mega refuse; a service with dp=2 on a CPU pipeline
    answers through two groups."""
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="not divisible"):
        tcont.ContinuousBatcher(tparams, tcfg, n_slots=6, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="single-device"):
        tcont.ContinuousBatcher(tparams, tcfg, n_slots=64, devices=["cpu"] * 2, megakernel=True)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices"):
            tsvc.dp_devices(torch.device("cuda"), 2)
    assert tsvc.dp_devices(torch.device("cpu"), 3) == ["cpu"] * 3
    assert tsvc.dp_devices(torch.device("cpu"), 1) is None
    for flags in (["--family", "cosy"], ["--grouped"], ["--mega"], ["--n-slots", "5"]):
        with pytest.raises(SystemExit):
            launch.main(["--ckpt", "unused.safetensors", "--device", "cpu", "--dp", "2", *flags])
    pipe = SparkPipeline(tcfg, tparams, FakeTok())
    tts = tsvc.ContinuousTTSService(pipe, n_slots=4, chunk=4, max_new_tokens=8, top_k=1, dp=2)
    try:
        assert len(tts.batcher._groups) == 2
        reqs = [tsvc.TTSRequest(text=f"voice {i}", global_tokens=[i + j for j in range(32)],
                                max_new_tokens=4, seed=i) for i in range(5)]
        assert all(tts.synthesize(r).error is None for r in reqs)
        assert tts.stats()["admitted"] >= 5
    finally:
        tts.close()

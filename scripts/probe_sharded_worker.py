"""Where a ``data/extract.run_sharded`` worker of the PyTorch port spends its
seconds on the card: the steps of ``SparkTarWorker``'s first call, each
timed from the pool's start, in 1 and then 2 processes of the ``spawn``
context (as run_sharded starts them).

The corpus is ``chip_smoke.py``'s phase 35 corpus (64 seeded utterances in
4 tars of 16), the model directory is BiCodec at ``BiCodecConfig()`` with
the wav2vec2-large-xlsr-53-shaped frontend, random weights from seed 0,
written by ``SparkAudioTokenizer.save_pretrained`` into a temporary
directory. Each worker reads it and tokenizes one tar twice (the second
pass is warm). Needs one NVIDIA GPU; from the repo root:

    python3 scripts/probe_sharded_worker.py
"""
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time

# the repo root, for chip_smoke and rwkvtts_torch (here and in the spawned workers)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker(t_pool, codec_dir, shard, out):
    """SparkTarWorker's first call, step by step: [(step, seconds since the
    pool started)]."""
    marks = [("spawned", round(time.time() - t_pool, 2))]

    def mark(what):
        marks.append((what, round(time.time() - t_pool, 2)))

    import torch
    mark("import torch")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    mark("cuda context")
    from pathlib import Path

    from rwkvtts_torch.codecs import spark_tokenizer as st
    from rwkvtts_torch.codecs import torch_import
    from rwkvtts_torch.convert import rwkv7_ckpt
    from rwkvtts_torch.data import extract, webdataset
    mark("import rwkvtts_torch codecs")
    import transformers  # noqa: F401
    mark("import transformers")
    d = Path(codec_dir)
    cfg = st.bicodec_config_from_yaml(d / "BiCodec" / "config.yaml")
    sd = rwkv7_ckpt.load_safetensors(str(d / "BiCodec" / "model.safetensors"))
    mark("bicodec safetensors read")
    params = torch_import.bicodec_from_state_dict(sd, cfg, torch.device("cuda"))
    torch.cuda.synchronize()
    mark("bicodec on card")
    w2v = st.Wav2Vec2Frontend.from_pretrained(d / "wav2vec2-large-xlsr-53", "cuda")
    torch.cuda.synchronize()
    mark("wav2vec2 from_pretrained (its modules' import, the read)")
    codec = st.SparkAudioTokenizer(cfg, params, w2v)
    n = extract.extract_spark_tokens(webdataset.iter_tar_samples(shard), codec, out, None)
    torch.cuda.synchronize()
    mark(f"extract {n} rows")
    extract.extract_spark_tokens(webdataset.iter_tar_samples(shard), codec, out + ".2", None)
    torch.cuda.synchronize()
    mark("extract again")
    return marks


def main():
    import torch

    import chip_smoke as cs
    from rwkvtts_torch.codecs import bicodec
    from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer, Wav2Vec2Frontend
    from rwkvtts_torch.data import corpus_tools

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as work:
        shards = corpus_tools.write_shards(cs.corpus_samples(), os.path.join(work, "shards"),
                                           samples_per_shard=cs.CORPUS_PER_SHARD)
        g = torch.Generator(device=dev).manual_seed(0)
        codec = SparkAudioTokenizer(
            cs.wav_codec_config(), bicodec.init_params(g, cs.wav_codec_config()),
            Wav2Vec2Frontend.from_config(cs.xlsr53_config(), seed=0, device=dev))
        codec_dir = os.path.join(work, "Spark-TTS")
        codec.save_pretrained(codec_dir)
        del codec
        torch.cuda.empty_cache()
        for n in (1, 2):
            t = time.time()
            with mp.get_context("spawn").Pool(n) as pool:
                res = pool.starmap(worker, [(t, codec_dir, shards[i],
                                             os.path.join(work, f"rows_{n}_{i}.jsonl"))
                                            for i in range(n)])
            print(f"probe: {n} worker(s), pool wall {time.time() - t:.2f} s")
            for r in res:
                print("probe:", json.dumps(r))


if __name__ == "__main__":
    main()

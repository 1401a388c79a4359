"""Raw-corpus tooling (counterpart of rwkvtts_tpu/data/corpus_tools.py,
without JAX): parquet -> JSONL builders (resumable), a webdataset shard
writer and re-packer, and a text-keyed sample cache.

The reference's scripts these follow:
- data/utils/create_lm_corpus_from_raw.py: parquet rows (HF audio-dataset
  layout: `audio.bytes` + transcription / language / speaker columns) ->
  Cosy speech-token JSONL, resumable per file by counting the lines
  already written (:40-56) and skipping that many rows (:64-69);
- data/utils/create_embeddings_from_raw.py: parquet rows -> per-speaker
  x-vector embedding JSONL;
- data/utils/convert_to_wds.py + process_wds.py: tar(.gz) archives
  re-packed into plain webdataset shards, side metadata joined onto each
  sample;
- utils/voxbox_lmdb_utils.py: an md5(text)-keyed store of token rows (LMDB
  there; sqlite3 here: stdlib, one file, no map_size to size).

The audio tokenizer / embedding extractor is a callable the caller passes:
the port's S3 tokenizer / CAM++ on the card (codecs/s3_tokenizer.py,
codecs/campplus.py) or any wav -> ids / wav -> vector function.

    python -m rwkvtts_torch.data.corpus_tools repack in.tar.gz --out-dir shards/
    python -m rwkvtts_torch.data.corpus_tools cache-build shards/*.tar --db cache.sqlite
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import sqlite3
import tarfile
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from rwkvtts_torch.utils import audio_io

log = logging.getLogger("rwkvtts_torch")


# ---------------------------------------------------------------------------
# Parquet streaming
# ---------------------------------------------------------------------------


def iter_parquet_rows(
    path: str,
    *,
    audio_key: str = "audio",
    sample_rate: int = 16000,
    skip: int = 0,
    batch_size: int = 256,
) -> Iterator[Dict[str, Any]]:
    """Stream rows from one parquet file, decoding the HF-style audio cell
    (`{bytes, path}` struct or raw bytes) to float32 mono at `sample_rate`.

    Yields {"audio": np.ndarray, "sample_rate": int, **scalar columns}.
    `skip` drops the first N rows without decoding audio (the resume path,
    reference create_lm_corpus_from_raw.py:64-69).
    """
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    seen = 0
    for batch in pf.iter_batches(batch_size=batch_size):
        cols = batch.to_pydict()
        names = list(cols.keys())
        n = len(cols[names[0]])
        for i in range(n):
            seen += 1
            if seen <= skip:
                continue
            row: Dict[str, Any] = {}
            for name in names:
                cell = cols[name][i]
                if name == audio_key:
                    data = cell.get("bytes") if isinstance(cell, dict) else cell
                    if data is None and isinstance(cell, dict) and cell.get("path"):
                        with open(cell["path"], "rb") as f:
                            data = f.read()
                    row["audio"] = audio_io.load_wav_bytes(bytes(data), sample_rate)
                    row["sample_rate"] = sample_rate
                else:
                    row[name] = cell
            yield row


def _count_lines(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return sum(1 for _ in f)


def build_jsonl_from_parquet(
    parquet_files: Sequence[str],
    out_dir: str,
    row_fn: Callable[[Dict[str, Any]], Optional[Dict[str, Any]]],
    *,
    sample_rate: int = 16000,
    resume: bool = True,
) -> int:
    """Per input file, write `<base>_tokens.jsonl` of `row_fn(sample)` rows.

    Resumable: an existing output's line count is trusted as the number of
    already-processed rows and that many input rows are skipped (exactly the
    reference's restart contract, create_lm_corpus_from_raw.py:40-69).
    row_fn returns the JSON-serializable row, or None to drop the sample.
    Returns the number of rows written this call.
    """
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for path in parquet_files:
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(out_dir, f"{base}_tokens.jsonl")
        skip = _count_lines(out_path) if resume else 0
        if skip:
            log.info("resuming %s at row %d", out_path, skip)
        mode = "a" if skip else "w"
        with open(out_path, mode, encoding="utf-8") as f:
            for sample in iter_parquet_rows(
                path, sample_rate=sample_rate, skip=skip
            ):
                row = row_fn(sample)
                if row is None:
                    continue
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
                written += 1
    return written


def cosy_token_row_fn(
    speech_tokenizer_fn: Callable[[np.ndarray], Sequence[int]],
    *,
    text_key: str = "transcription",
) -> Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """Rows for the Cosy LM trainer from raw parquet corpora —
    {tts_speech_tokens, text, language, speaker, prompt_text,
    llm_prompt_speech_token} (create_lm_corpus_from_raw.py:99-104)."""

    def fn(sample: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        text = sample.get(text_key) or sample.get("text")
        if not text:
            return None
        tokens = list(map(int, speech_tokenizer_fn(sample["audio"])))
        return {
            "tts_speech_tokens": tokens,
            "text": text,
            "language": sample.get("language", ""),
            "speaker": sample.get("speaker", ""),
            "prompt_text": "",
            "llm_prompt_speech_token": [],
        }

    return fn


def xvector_row_fn(
    embed_fn: Callable[[np.ndarray], np.ndarray],
    *,
    per_speaker_cap: int = 10,
) -> Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """Speaker x-vector rows {speaker, language, embedding} with the
    reference's per-(speaker, language) cap of 10 clips
    (create_embeddings_from_raw.py:75-102). embed_fn: wav -> 1-D vector
    (codecs/campplus.py native CAM++ ≙ the ONNX session there)."""
    counts: Dict[tuple, int] = {}

    def fn(sample: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        key = (sample.get("speaker", ""), sample.get("language", ""))
        if counts.get(key, 0) >= per_speaker_cap:
            return None
        counts[key] = counts.get(key, 0) + 1
        emb = np.asarray(embed_fn(sample["audio"]), np.float32).reshape(-1)
        return {
            "speaker": key[0],
            "language": key[1],
            "embedding": emb.tolist(),
        }

    return fn


# ---------------------------------------------------------------------------
# Webdataset shard writing / re-packing
# ---------------------------------------------------------------------------


def write_shards(
    samples: Iterable[Dict[str, Any]],
    out_dir: str,
    *,
    prefix: str = "shard",
    samples_per_shard: int = 1000,
    sample_rate: int = 16000,
) -> List[str]:
    """Write samples into plain webdataset tars: `<key>.wav` (pcm16) +
    `<key>.json` per sample, `samples_per_shard` samples per tar.

    Accepts the dict layout iter_tar_samples yields ({audio, __key__?,
    **metadata}); audio may be absent (json-only corpora). This is the
    writer the reference lacks in-repo (it converts with convert_to_wds.py
    and inspects with process_wds.py); it round-trips with
    data/webdataset.iter_tar_samples, and its tars are byte for byte the
    JAX package's.
    """
    import wave as wave_mod

    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    tf: Optional[tarfile.TarFile] = None
    n_in_shard = 0

    def encode_wav(audio: np.ndarray) -> bytes:
        buf = io.BytesIO()
        pcm = (np.clip(np.asarray(audio, np.float32), -1, 1) * 32767.0).astype(
            np.int16
        )
        with wave_mod.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())
        return buf.getvalue()

    def add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, fileobj=io.BytesIO(data))

    try:
        for i, sample in enumerate(samples):
            if tf is None or n_in_shard >= samples_per_shard:
                if tf is not None:
                    tf.close()
                shard_path = os.path.join(
                    out_dir, f"{prefix}-{len(paths):06d}.tar"
                )
                tf = tarfile.open(shard_path, "w")
                paths.append(shard_path)
                n_in_shard = 0
            key = str(sample.get("__key__", f"{i:09d}"))
            meta = {
                k: v
                for k, v in sample.items()
                if k not in ("audio", "sample_rate", "__key__")
                and not isinstance(v, (bytes, np.ndarray))
            }
            if sample.get("audio") is not None:
                add(tf, f"{key}.wav", encode_wav(sample["audio"]))
            add(
                tf,
                f"{key}.json",
                json.dumps(meta, ensure_ascii=False).encode("utf-8"),
            )
            n_in_shard += 1
    finally:
        if tf is not None:
            tf.close()
    return paths


def repack_tars(
    inputs: Sequence[str],
    out_dir: str,
    *,
    metadata: Optional[Dict[str, Dict[str, Any]]] = None,
) -> List[str]:
    """Re-pack tar / tar.gz archives into plain uncompressed tars, merging
    `metadata[key]` into each sample's .json member (the reference's
    convert_to_wds.py flow: gzip-in, metadata join, tar-out). Non-json
    members stream through byte-for-byte. Returns output paths."""
    os.makedirs(out_dir, exist_ok=True)
    outs: List[str] = []
    for path in inputs:
        name = os.path.basename(path)
        for suffix in (".tar.gz", ".tgz", ".tar"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
                break
        out_path = os.path.join(out_dir, name + ".tar")
        mode = "r:gz" if path.endswith((".tar.gz", ".tgz")) else "r:"
        with tarfile.open(path, mode) as tin, tarfile.open(out_path, "w") as tout:
            for m in tin:
                if not m.isfile():
                    continue
                data = tin.extractfile(m).read()
                if metadata is not None and m.name.endswith(".json"):
                    key = m.name[: -len(".json")]
                    extra = metadata.get(key) or metadata.get(
                        os.path.basename(key)
                    )
                    if extra:
                        obj = json.loads(data)
                        obj.update(extra)
                        data = json.dumps(obj, ensure_ascii=False).encode("utf-8")
                info = tarfile.TarInfo(m.name)
                info.size = len(data)
                tout.addfile(info, fileobj=io.BytesIO(data))
        outs.append(out_path)
    return outs


# ---------------------------------------------------------------------------
# Text-keyed sample cache (voxbox_lmdb_utils parity, sqlite3 backend)
# ---------------------------------------------------------------------------


class TextKeyedCache:
    """md5(text)-keyed KV store of JSON rows.

    The reference builds this with LMDB (utils/voxbox_lmdb_utils.py:19-49)
    to look token rows up by transcription text; a single-file sqlite3
    table gives the same contract (stdlib, no 100 GB map_size
    pre-commitment, concurrent readers)."""

    def __init__(self, path: str):
        self.path = path
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v TEXT)"
        )
        self._db.commit()

    @staticmethod
    def key(text: str) -> str:
        return hashlib.md5(text.encode("utf-8")).hexdigest()

    def put(self, text: str, obj: Dict[str, Any]) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO kv VALUES (?, ?)",
            (self.key(text), json.dumps(obj, ensure_ascii=False)),
        )

    def get(self, text: str) -> Optional[Dict[str, Any]]:
        row = self._db.execute(
            "SELECT v FROM kv WHERE k = ?", (self.key(text),)
        ).fetchone()
        return None if row is None else json.loads(row[0])

    def __len__(self) -> int:
        return self._db.execute("SELECT COUNT(*) FROM kv").fetchone()[0]

    def commit(self) -> None:
        self._db.commit()

    def close(self) -> None:
        self._db.commit()
        self._db.close()

    def __enter__(self) -> "TextKeyedCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def build_from_tars(
        self,
        tar_paths: Sequence[str],
        *,
        drop_fields: Sequence[str] = ("text", "syllables"),
    ) -> int:
        """Index every json sample in the tars by its `text` field, storing
        the row minus `drop_fields` (voxbox_lmdb_utils.py:28-44: the value
        is the row with text/syllables popped). Returns rows stored."""
        from rwkvtts_torch.data.webdataset import iter_tar_samples

        n = 0
        for path in tar_paths:
            for sample in iter_tar_samples(path):
                text = sample.get("text")
                if not text:
                    continue
                obj = {
                    k: v
                    for k, v in sample.items()
                    if k not in drop_fields
                    and k != "__key__"
                    and not isinstance(v, (bytes, np.ndarray))
                }
                self.put(text, obj)
                n += 1
            self.commit()
        return n


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m rwkvtts_torch.data.corpus_tools", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("repack", help="tar(.gz) -> plain wds tars (+json merge)")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--metadata-jsonl", help="rows with __key__ to merge by key")

    sc = sub.add_parser("cache-build", help="index tars into a text-keyed cache")
    sc.add_argument("tars", nargs="+")
    sc.add_argument("--db", required=True)

    sg = sub.add_parser("cache-get", help="look one text up")
    sg.add_argument("--db", required=True)
    sg.add_argument("--text", required=True)

    args = p.parse_args(argv)
    if args.cmd == "repack":
        metadata = None
        if args.metadata_jsonl:
            metadata = {}
            with open(args.metadata_jsonl, encoding="utf-8") as f:
                for line in f:
                    row = json.loads(line)
                    metadata[str(row.pop("__key__"))] = row
        outs = repack_tars(args.inputs, args.out_dir, metadata=metadata)
        print("\n".join(outs))
    elif args.cmd == "cache-build":
        with TextKeyedCache(args.db) as cache:
            n = cache.build_from_tars(args.tars)
        print(f"stored {n} rows in {args.db}")
    elif args.cmd == "cache-get":
        with TextKeyedCache(args.db) as cache:
            print(json.dumps(cache.get(args.text), ensure_ascii=False))


if __name__ == "__main__":
    main()

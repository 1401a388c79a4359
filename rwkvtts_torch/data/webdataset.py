"""Webdataset-style tar reading: (wav, json / txt) sample streams
(counterpart of rwkvtts_tpu/data/webdataset.py, without JAX).

Members that share a basename form one sample, {__key__, audio (float32 at
`sample_rate`), text, json fields...}. Every reader here goes through the
C++ streamer (``utils/native.NativeTarStream``, a reader thread filling a
bounded queue, built with g++ at first use; a build that fails raises).
``read_tars_plain`` is its plain version through the stdlib ``tarfile``,
which the streamer is held against: the same samples in the same order.

A shard that fails to read is cut: every sample before the cut is yielded
once, and the sample the cut goes through is dropped, since it may lack
members (the JAX package's native path yields it without its later
members, its stdlib path drops it, and repeats the samples before it on
each of its retries). Where the cut is inside a member's data, that member
names the sample; where it is elsewhere (a header, padding), the sample in
progress is dropped. The plain version retries a failed shard twice,
skipping the members already delivered, and then cuts it the same way.
"""
from __future__ import annotations

import json
import logging
import random
import tarfile
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rwkvtts_torch.utils import audio_io
from rwkvtts_torch.utils.native import NativeTarStream

log = logging.getLogger("rwkvtts_torch")

BLOCK = 512
# the first bytes of a gzip, bzip2, xz or zstd stream
COMPRESSED_MAGIC = (b"\x1f\x8b", b"BZh", b"\xfd7zXZ\x00", b"\x28\xb5\x2f\xfd")
# (shard index, member name, bytes); a None name marks the shard's cut, with
# the name of the member whose data was cut (or None) in place of the bytes
Member = Tuple[int, Optional[str], Any]


def check_tar(path: str) -> bool:
    """Whether tarfile can list every member (the reference's validity
    pre-check, multiple_webdataset.py:76-88)."""
    try:
        with tarfile.open(path) as tf:
            tf.getmembers()
        return True
    except (tarfile.TarError, OSError, EOFError):
        return False


def _decode_member(name: str, data: bytes, sample: Dict[str, Any], sample_rate: int) -> None:
    ext = name.rsplit(".", 1)[-1].lower()
    if ext == "wav":
        sample["audio"] = audio_io.load_wav_bytes(data, sample_rate)
    elif ext == "json":
        sample.update(json.loads(data))
    elif ext in ("txt", "text"):
        sample["text"] = data.decode("utf-8", errors="replace")
    else:
        sample[ext] = data


def _ends_cleanly(tf: tarfile.TarFile) -> bool:
    """tarfile stops quietly at a cut header; the archive ended cleanly only
    if the block where it stopped is an end-of-archive block or the end of
    the file."""
    tf.fileobj.seek(tf.offset)
    block = tf.fileobj.read(BLOCK)
    return not block or block == bytes(BLOCK)


def _tar_members(path: str, shard: int, retries: int) -> Iterator[Member]:
    """One tar's regular members through tarfile; a retry skips the members
    already delivered, and a shard that still fails ends with its cut."""
    delivered = 0
    for attempt in range(retries + 1):
        cut = None
        try:
            with tarfile.open(path) as tf:
                seen = 0
                for m in tf:
                    if not m.isfile():
                        continue
                    seen += 1
                    if seen <= delivered:
                        continue
                    cut = m.name
                    data = tf.extractfile(m).read()
                    cut = None
                    delivered += 1
                    yield shard, m.name, data
                if not _ends_cleanly(tf):
                    raise tarfile.ReadError("archive cut: no end-of-archive block")
            return
        except (tarfile.TarError, OSError, EOFError) as e:
            log.warning("tar read of %s failed (%s), attempt %d/%d", path, e, attempt + 1,
                        retries + 1)
    yield shard, None, cut


def _group(members: Iterable[Member], sample_rate: int) -> Iterator[Dict[str, Any]]:
    """Members in archive order -> samples; consecutive members of one shard
    sharing a basename form one sample. A shard's cut drops the sample it
    goes through: the cut member's, or the one in progress."""
    key: Optional[Tuple[int, str]] = None
    sample: Dict[str, Any] = {}
    for shard, name, data in members:
        if name is None:
            if key is not None and key[0] == shard:
                if data is not None and data.rsplit(".", 1)[0] != key[1] and sample:
                    yield {"__key__": key[1], **sample}  # whole: the cut is in the next
                key, sample = None, {}
            continue
        base = (shard, name.rsplit(".", 1)[0])
        if key is not None and base != key and sample:
            yield {"__key__": key[1], **sample}
        if base != key:
            sample = {}
        key = base
        _decode_member(name, data, sample, sample_rate)
    if key is not None and sample:
        yield {"__key__": key[1], **sample}


def _stream(tar_paths: Sequence[str], sample_rate: int) -> Iterator[Dict[str, Any]]:
    """The samples of `tar_paths` in order, through the C++ streamer; a
    compressed shard raises (the streamer reads plain tars, as
    corpus_tools.repack_tars writes them)."""
    for p in tar_paths:
        try:
            with open(p, "rb") as f:
                head = f.read(6)
        except OSError:
            continue  # the streamer cuts an unreadable shard
        if head.startswith(COMPRESSED_MAGIC):
            raise ValueError(f"{p}: a compressed tar; the streamer reads plain tars "
                             f"(corpus_tools.repack_tars writes them)")
    with NativeTarStream(tar_paths) as ts:
        yield from _group(ts, sample_rate)
        if ts.errors:
            log.warning("tar streamer: %d shard(s) cut", ts.errors)


def iter_tar_samples(path: str, sample_rate: int = 16000) -> Iterator[Dict[str, Any]]:
    """Samples {__key__, audio (float32), text, ...} of one tar."""
    return _stream([path], sample_rate)


def read_tars_plain(tar_paths: Sequence[str], sample_rate: int = 16000, retries: int = 2
                    ) -> Iterator[Dict[str, Any]]:
    """The samples of `tar_paths` in order through tarfile: the plain
    version of the streamer's readers."""
    for i, p in enumerate(tar_paths):
        yield from _group(_tar_members(p, i, retries), sample_rate)


class MultipleWebDataset:
    """Every sample of the valid tars, in memory, shuffled by
    ``np.random.default_rng(seed).permutation`` (the reference's
    MultipleWebDataset)."""

    def __init__(self, tar_paths: Sequence[str], sample_rate: int = 16000,
                 shuffle: bool = True, seed: int = 0, verify: bool = True):
        valid = []
        for p in tar_paths:
            if verify and not check_tar(p):
                log.warning("skipping invalid tar %s", p)
                continue
            valid.append(p)
        self.samples: List[Dict[str, Any]] = list(_stream(valid, sample_rate))
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(self.samples))
            self.samples = [self.samples[i] for i in order]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def __iter__(self):
        return iter(self.samples)


def stream_tars(tar_paths: Sequence[str], sample_rate: int = 16000, shard_index: int = 0,
                num_shards: int = 1, shuffle_buffer: int = 0, seed: int = 0
                ) -> Iterator[Dict[str, Any]]:
    """The samples of this worker's tars (every `num_shards`-th from
    `shard_index`), streamed. `shuffle_buffer > 0` draws each sample at
    random from a rolling buffer of that size (``random.Random(seed)``,
    the webdataset ``.shuffle(N)`` of the reference's ASR pipeline)."""
    mine = [p for i, p in enumerate(tar_paths) if i % num_shards == shard_index]
    if shuffle_buffer <= 0:
        yield from _stream(mine, sample_rate)
        return
    rng = random.Random(seed)
    buf: List[Dict[str, Any]] = []
    for s in _stream(mine, sample_rate):
        buf.append(s)
        if len(buf) >= shuffle_buffer:
            i = rng.randrange(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf

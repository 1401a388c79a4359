"""RWKV "world" tokenizer: byte-level greedy longest match, 65536 ids (a
copy of rwkvtts_tpu/utils/tokenizer.py).

The vocabulary is the published RWKV v20230424 world vocabulary, kept
byte for byte in rwkvtts_torch/assets/; id 0 is <|endoftext|>. The bytes
are matched by the C++ byte trie of csrc/world_tokenizer.cpp
(``utils/native.NativeTrieEncoder``, built with g++ at first use); a trie
that cannot be built raises. ``encode_plain`` is the plain version the
trie is held against: a pure-Python matcher that probes the token lengths
occurring for the current first byte, longest first. Added tokens
(SPCT_*) get the ids after the base vocabulary and are matched on the
string level first, as HF ``tokenizer.add_tokens`` splits special tokens.
"""
from __future__ import annotations

import ast
import functools
import os
from typing import Callable, Dict, Iterable, List, Sequence

from rwkvtts_torch.utils.native import NativeTrieEncoder

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")
VOCAB_FILE = os.path.abspath(os.path.join(_ASSET_DIR, "rwkv_vocab_v20230424.txt"))

ENDOFTEXT_ID = 0
WORLD_VOCAB_SIZE = 65536


class WorldTokenizer:
    def __init__(self, vocab_file: str = VOCAB_FILE, added_tokens: Sequence[str] = ()):
        self.id_to_bytes: Dict[int, bytes] = {ENDOFTEXT_ID: b"<|endoftext|>"}
        self.bytes_to_id: Dict[bytes, int] = {}
        with open(vocab_file, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                idx_str, rest = line.split(" ", 1)
                tok_repr, length = rest.rsplit(" ", 1)
                tok = ast.literal_eval(tok_repr)
                bs = tok.encode("utf-8") if isinstance(tok, str) else tok
                if len(bs) != int(length):
                    raise ValueError(f"{vocab_file}: bad vocabulary line {line!r}")
                idx = int(idx_str)
                self.id_to_bytes[idx] = bs
                self.bytes_to_id[bs] = idx

        # for each first byte, the token lengths that occur, longest first
        by_first: Dict[int, set] = {}
        for bs in self.bytes_to_id:
            by_first.setdefault(bs[0], set()).add(len(bs))
        self._lengths_by_first = {b: sorted(ls, reverse=True) for b, ls in by_first.items()}
        self._trie = self._build_trie()

        self.added_token_to_id: Dict[str, int] = {}
        self.id_to_added: Dict[int, str] = {}
        self._base_size = WORLD_VOCAB_SIZE
        for i, t in enumerate(added_tokens):
            tid = self._base_size + i
            self.added_token_to_id[t] = tid
            self.id_to_added[tid] = t
        self._added_sorted = sorted(self.added_token_to_id, key=len, reverse=True)

    def _build_trie(self) -> NativeTrieEncoder:
        return NativeTrieEncoder((tid, bs) for bs, tid in self.bytes_to_id.items())

    def __getstate__(self):
        # the trie is a handle into this process's library: rebuilt on unpickling
        return {k: v for k, v in self.__dict__.items() if k != "_trie"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._trie = self._build_trie()

    def _encode_bytes(self, src: bytes) -> List[int]:
        return self._trie.encode_bytes(src)

    def _encode_bytes_plain(self, src: bytes) -> List[int]:
        out: List[int] = []
        i, n = 0, len(src)
        b2id = self.bytes_to_id
        lengths = self._lengths_by_first
        while i < n:
            tid = None
            for ln in lengths.get(src[i], ()):  # longest first
                if i + ln > n:
                    continue
                got = b2id.get(src[i:i + ln])
                if got is not None:
                    tid = got
                    i += ln
                    break
            if tid is None:
                raise ValueError(f"unencodable byte {src[i]:#x} at position {i}")
            out.append(tid)
        return out

    def encode(self, text: str) -> List[int]:
        return self._encode(text, self._encode_bytes)

    def encode_plain(self, text: str) -> List[int]:
        """`encode` through the pure-Python matcher (the trie's plain version)."""
        return self._encode(text, self._encode_bytes_plain)

    def _encode(self, text: str, match: Callable[[bytes], List[int]]) -> List[int]:
        if not self.added_token_to_id:
            return match(text.encode("utf-8"))
        # split on added tokens (greedy, longest first)
        out: List[int] = []
        rest = text
        while rest:
            best_pos, best_tok = None, None
            for t in self._added_sorted:
                p = rest.find(t)
                if p != -1 and (best_pos is None or p < best_pos or (
                    p == best_pos and len(t) > len(best_tok)
                )):
                    best_pos, best_tok = p, t
            if best_pos is None:
                out.extend(match(rest.encode("utf-8")))
                break
            if best_pos:
                out.extend(match(rest[:best_pos].encode("utf-8")))
            out.append(self.added_token_to_id[best_tok])
            rest = rest[best_pos + len(best_tok):]
        return out

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(
            self.id_to_added[i].encode("utf-8") if i in self.id_to_added
            else self.id_to_bytes[i]
            for i in ids
        )

    @property
    def vocab_size(self) -> int:
        return self._base_size + len(self.added_token_to_id)


@functools.lru_cache(maxsize=4)
def get_world_tokenizer(n_spct: int = 0) -> WorldTokenizer:
    """The base world tokenizer, optionally with SPCT_0..SPCT_{n-1} appended
    (the controllable-TTS property tokens, ids 65536 + i)."""
    return WorldTokenizer(added_tokens=tuple(f"SPCT_{i}" for i in range(n_spct)))

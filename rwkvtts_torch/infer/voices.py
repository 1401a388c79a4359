"""Persisted Cosy voice library (counterpart of rwkvtts_tpu/infer/voices.py),
the reference's `spk2info` equivalent.

The reference ships a spk2info.pt dict {spk_id: {embedding, speech_token,
speech_feat}} consumed by frontend_sft/inference_sft
(third_party/cosyvoice/cli/frontend.py:60-64,154-158). Here each voice is
one .npz with the zero-shot condition triple (prompt speech tokens, prompt
mel, x-vector) plus an optional transcript, extracted once from a
reference clip and reusable across sessions without re-running the
frontend models. The files are the JAX package's (same keys, dtypes and
format), so a library written by either package reads in the other.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

Condition = Tuple[np.ndarray, np.ndarray, np.ndarray]  # tokens, mel, emb


class CosyVoiceLibrary:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._cache: Dict[str, Dict[str, np.ndarray]] = {}

    def _path(self, name: str) -> str:
        safe = "".join(c for c in name if c.isalnum() or c in "-_.")
        if not safe:
            raise ValueError(f"invalid voice name: {name!r}")
        return os.path.join(self.dir, f"{safe}.npz")

    def speakers(self) -> List[str]:
        return sorted(
            f[: -len(".npz")] for f in os.listdir(self.dir) if f.endswith(".npz")
        )

    def register(
        self,
        name: str,
        prompt_speech_tokens: np.ndarray,
        prompt_mel: np.ndarray,
        spk_embedding: np.ndarray,
        prompt_text: str = "",
    ) -> None:
        np.savez(
            self._path(name),
            tokens=np.asarray(prompt_speech_tokens, np.int64),
            mel=np.asarray(prompt_mel, np.float32),
            emb=np.asarray(spk_embedding, np.float32),
            text=np.asarray(prompt_text),
        )
        self._cache.pop(name, None)

    def register_from_wav(
        self, pipeline, name: str, prompt_wav: np.ndarray,
        prompt_text: str = "", prompt_sr: int = 16000,
    ) -> None:
        """Run the zero-shot frontend once and persist the condition."""
        tokens, mel, emb = pipeline.frontend_zero_shot(prompt_wav, prompt_sr)
        self.register(name, tokens, mel, emb, prompt_text)

    def register_from_wavs(
        self, pipeline, name: str, prompt_wavs,
        prompt_text: str = "", prompt_sr: int = 16000,
    ) -> None:
        """Multi-clip registration: the speaker embedding is the centroid
        of all clips' x-vectors (the reference's KMeans-with-one-cluster ==
        the mean, data/utils/convert_embeddings_2_pt.py:24-26); the prompt
        tokens/mel come from the first clip — only the x-vector is
        extracted from the rest (not the full zero-shot frontend)."""
        prompt_wavs = list(prompt_wavs)
        if not prompt_wavs:
            raise ValueError("register_from_wavs needs at least one clip")
        tokens, mel, emb0 = pipeline.frontend_zero_shot(
            np.asarray(prompt_wavs[0]), prompt_sr
        )
        embs = [np.asarray(emb0, np.float32)]
        if len(prompt_wavs) > 1:
            from rwkvtts_torch.utils import audio_io

            for w in prompt_wavs[1:]:
                w16 = audio_io.resample(
                    np.asarray(w, np.float32), prompt_sr, 16000
                )
                embs.append(np.asarray(pipeline.spk_embed_fn(w16), np.float32))
        emb = np.mean(np.stack(embs), axis=0)
        self.register(name, tokens, mel, emb, prompt_text)

    def get(self, name: str) -> Dict[str, np.ndarray]:
        if name not in self._cache:
            path = self._path(name)
            if not os.path.exists(path):
                raise KeyError(name)
            with np.load(path) as z:
                self._cache[name] = {
                    "tokens": z["tokens"], "mel": z["mel"], "emb": z["emb"],
                    "text": str(z["text"]),
                }
        return self._cache[name]

    def synthesize(self, pipeline, name: str, text: str, **kw):
        """SFT-style synthesis with a stored voice (inference_sft parity:
        the stored condition replaces the per-call frontend)."""
        v = self.get(name)
        return pipeline.synthesize(
            text,
            prompt_text=v["text"],
            prompt_speech_tokens=v["tokens"].tolist(),
            prompt_mel=v["mel"],
            spk_embedding=v["emb"],
            **kw,
        )

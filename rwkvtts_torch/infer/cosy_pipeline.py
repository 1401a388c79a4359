"""CosyVoice2-style TTS orchestrator: RWKV-7 speech LM -> flow -> HiFT
(counterpart of rwkvtts_tpu/infer/cosy_pipeline.py, the route that
decodes through the whole-step kernel).

The constructor keeps the LM parameters for the prompt prefill and packs
the int8 weights of the B=1 decode step (``ops/decode_mega.pack_mega``);
every decode step goes through that step, the CUDA kernels on a card.
``token2wav`` is the non-streaming flow + vocoder; the streaming path is
``infer/streaming.stream_synthesize``. Prompt features (speech tokens, the
prompt mel, the speaker embedding) are passed in precomputed: the S3
tokenizer and CAM++ frontends are not ported yet, nor is the non-kernel
decode route of ``generate_speech_tokens`` / ``synthesize``.

Everything runs on `device`, a CUDA device unless the caller asks for
the CPU (where the kernels' plain versions run).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rwkvtts_torch.codecs import flow as flow_lib
from rwkvtts_torch.codecs import hift as hift_lib
from rwkvtts_torch.ops import decode_mega as dm


class CosyPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        flow_cfg: Optional[flow_lib.FlowConfig] = None,
        flow_params=None,
        hift_cfg: Optional[hift_lib.HiFTConfig] = None,
        hift_params=None,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        to_dev = lambda tree: None if tree is None else _tree_to(tree, self.device)
        self.lm_cfg = lm_cfg
        self.lm_params = to_dev(lm_params)
        self.lm_mega = dm.pack_mega(self.lm_params, lm_cfg.backbone)
        # the WKV state carried between decode steps: bf16, the deployed
        # carry of the JAX package (pack_mega_state's default)
        self.wkv_dtype = torch.bfloat16
        self.tok = text_tokenizer
        self.flow_cfg, self.flow_params = flow_cfg, to_dev(flow_params)
        self.hift_cfg, self.hift_params = hift_cfg, to_dev(hift_params)
        self.sample_rate = None if hift_cfg is None else hift_cfg.sampling_rate

    @torch.inference_mode()
    def token2wav(
        self,
        speech_tokens: Sequence[int],
        prompt_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,     # (2 * len(prompt_tokens), 80)
        spk_embedding: Optional[np.ndarray] = None,  # (192,)
        n_timesteps: int = 10,
        seed: int = 0,
    ) -> np.ndarray:
        """Speech tokens -> wav (non-streaming): the flow over prompt +
        tokens, then HiFT; noise from `seed` (flow) and `seed + 1` (HiFT)."""
        if self.flow_params is None or self.hift_params is None:
            raise RuntimeError("flow / HiFT parameters not loaded")
        fcfg, dev = self.flow_cfg, self.device
        tokens = np.concatenate([np.asarray(prompt_tokens, np.int64),
                                 np.asarray(speech_tokens, np.int64)])[None]
        if spk_embedding is None:
            spk_embedding = np.zeros((fcfg.spk_embed_dim,), np.float32)
        if prompt_mel is None:
            prompt_mel = np.zeros((0, fcfg.output_size), np.float32)
        tokens = torch.from_numpy(tokens).to(dev)
        noise = flow_lib.NoiseTable(seed, fcfg.output_size, dev)(fcfg.token_mel_ratio * tokens.shape[1])
        mel = flow_lib.inference(
            self.flow_params, fcfg, tokens, torch.ones(tokens.shape, device=dev),
            torch.from_numpy(np.asarray(prompt_mel, np.float32)[None]).to(dev),
            prompt_mel.shape[0], torch.from_numpy(np.asarray(spk_embedding, np.float32)[None]).to(dev),
            noise, n_timesteps=n_timesteps)
        wav, _ = hift_lib.inference(self.hift_params, self.hift_cfg, mel,
                                    generator=torch.Generator().manual_seed(seed + 1))
        return wav[0].cpu().numpy()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


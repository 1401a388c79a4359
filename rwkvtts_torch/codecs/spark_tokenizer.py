"""The Spark route's audio tokenizer: wav -> (global, semantic) tokens and
tokens -> wav (counterpart of rwkvtts_tpu/codecs/spark_tokenizer.py).

BiCodec (codecs/bicodec.py) with the wav2vec2-large-xlsr-53 feature
frontend: the mean of the wav2vec2 hidden states 11, 14 and 16 (the
reference's audio_tokenizer.py:89-103). The frontend runs on
transformers' PyTorch ``Wav2Vec2Model``, read from the model directory
the reference uses or built from a ``Wav2Vec2Config`` with seeded random
weights.

A Spark-TTS model directory holds
    <model_dir>/BiCodec/model.safetensors + config.yaml
    <model_dir>/wav2vec2-large-xlsr-53/

Everything runs on `device`, a CUDA device unless the caller asks for
the CPU.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rwkvtts_torch.codecs import bicodec, nn, torch_import
from rwkvtts_torch.convert import rwkv7_ckpt
from rwkvtts_torch.utils import audio_io

# the wav2vec2 hidden states whose mean is the feature (index 0 is the
# embedding, index i the output of layer i)
HIDDEN_STATES = (11, 14, 16)


def device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the codec on the CPU")
    return dev


def bicodec_config_from_yaml(path: Union[str, Path]) -> bicodec.BiCodecConfig:
    """A BiCodec model directory's config.yaml -> BiCodecConfig."""
    import yaml

    with open(path) as f:
        full = yaml.safe_load(f)
    c = full["audio_tokenizer"]

    def stack(d):
        return bicodec.VocosStackConfig(
            input_channels=d["input_channels"], vocos_dim=d["vocos_dim"],
            vocos_intermediate_dim=d["vocos_intermediate_dim"],
            vocos_num_layers=d["vocos_num_layers"], out_channels=d["out_channels"],
            sample_ratios=tuple(d.get("sample_ratios", (1, 1))),
            condition_dim=d.get("condition_dim"),
            use_tanh_at_final=d.get("use_tanh_at_final", False))

    m, q, dec, spk = (c["mel_params"], c["quantizer"], c["decoder"], c["speaker_encoder"])
    return bicodec.BiCodecConfig(
        mel=bicodec.MelParams(sample_rate=m["sample_rate"], n_fft=m["n_fft"],
                              win_length=m["win_length"], hop_length=m["hop_length"],
                              mel_fmin=m["mel_fmin"], mel_fmax=m.get("mel_fmax"),
                              num_mels=m["num_mels"]),
        encoder=stack(c["encoder"]),
        quantizer_codebook_size=q["codebook_size"],
        quantizer_codebook_dim=q["codebook_dim"],
        quantizer_input_dim=q["input_dim"],
        quantizer_commitment=q.get("commitment", 0.25),
        prenet=stack(c["prenet"]),
        postnet=stack(c["postnet"]),
        wave=bicodec.WaveGeneratorConfig(input_channel=dec["input_channel"],
                                         channels=dec["channels"], rates=tuple(dec["rates"]),
                                         kernel_sizes=tuple(dec["kernel_sizes"])),
        speaker=bicodec.SpeakerEncoderConfig(
            input_dim=spk["input_dim"], out_dim=spk["out_dim"], latent_dim=spk["latent_dim"],
            token_num=spk["token_num"], fsq_levels=tuple(spk["fsq_levels"]),
            fsq_num_quantizers=spk["fsq_num_quantizers"]),
        ref_segment_duration=full.get("ref_segment_duration", 6.0),
        latent_hop_length=full.get("latent_hop_length", 320),
    )


class Wav2Vec2Frontend:
    """wav2vec2 features: the waveform normalised to zero mean and unit
    variance (the feature extractor's do_normalize, eps 1e-7), then the
    mean of hidden states 11, 14 and 16. The layers run one by one up to
    the last state taken, in float32 with TF32 off, as the codec."""

    def __init__(self, model):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    @classmethod
    def from_pretrained(cls, model_dir: Union[str, Path], device="cuda") -> "Wav2Vec2Frontend":
        from transformers import Wav2Vec2Model

        return cls(Wav2Vec2Model.from_pretrained(str(model_dir)).float().to(device_of(device)))

    @classmethod
    def from_config(cls, config, seed: int = 0, device="cuda") -> "Wav2Vec2Frontend":
        """Random weights for a ``transformers.Wav2Vec2Config`` (the model's
        own initialisation under torch's generator seeded with `seed`)."""
        from transformers import Wav2Vec2Model

        dev = device_of(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = Wav2Vec2Model(config)
        return cls(model.float().to(dev))

    @torch.inference_mode()
    def __call__(self, wavs: np.ndarray) -> torch.Tensor:
        """wavs (B, T) float32 -> features (B, frames, hidden) on the device."""
        x = wavs - wavs.mean(axis=-1, keepdims=True)
        x = x / np.sqrt(x.var(axis=-1, keepdims=True) + 1e-7)
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        m, enc = self.model, self.model.encoder
        first = lambda out: out[0] if isinstance(out, tuple) else out
        with nn.f32():
            h = first(m.feature_projection(m.feature_extractor(x).transpose(1, 2)))
            h = h + enc.pos_conv_embed(h)
            states = [h]
            for layer in enc.layers[:max(HIDDEN_STATES)]:
                states.append(first(layer(states[-1])))
            if max(HIDDEN_STATES) == len(enc.layers):  # the last state is normed
                states[-1] = enc.layer_norm(states[-1])
        return sum(states[i] for i in HIDDEN_STATES) / len(HIDDEN_STATES)


class SparkAudioTokenizer:
    """wav <-> (global tokens, semantic tokens) for the Spark route."""

    def __init__(self, cfg: bicodec.BiCodecConfig, params: Dict[str, Any],
                 wav2vec2: Optional[Wav2Vec2Frontend] = None, sample_rate: int = 16000,
                 volume_normalize: bool = True):
        self.cfg = cfg
        self.params = params
        self.device = params["quantizer"]["codebook"].device
        self.wav2vec2 = wav2vec2
        self.sample_rate = sample_rate
        self.volume_normalize = volume_normalize

    @classmethod
    def from_pretrained(cls, model_dir: Union[str, Path], device="cuda", **kw
                        ) -> "SparkAudioTokenizer":
        model_dir = Path(model_dir)
        dev = device_of(device)
        cfg = bicodec_config_from_yaml(model_dir / "BiCodec" / "config.yaml")
        sd = rwkv7_ckpt.load_safetensors(str(model_dir / "BiCodec" / "model.safetensors"))
        params = torch_import.bicodec_from_state_dict(sd, cfg, dev)
        w2v_dir = model_dir / "wav2vec2-large-xlsr-53"
        wav2vec2 = Wav2Vec2Frontend.from_pretrained(w2v_dir, dev) if w2v_dir.exists() else None
        return cls(cfg, params, wav2vec2, **kw)

    def extract_features(self, wavs: np.ndarray) -> torch.Tensor:
        """wavs (B, T) float32 -> (B, T // 320, 1024)."""
        if self.wav2vec2 is None:
            raise RuntimeError("wav2vec2 frontend not loaded (tokenize needs the "
                               "wav2vec2-large-xlsr-53 weights in the model dir)")
        return self.wav2vec2(wavs)

    @torch.inference_mode()
    def tokenize(self, wav: Union[str, Path, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """audio -> (global tokens (1, Q, 32), semantic tokens (1, T))."""
        if not isinstance(wav, np.ndarray):
            wav = audio_io.load_wav(wav, self.sample_rate, volume_normalize=self.volume_normalize)
        ref = bicodec.get_ref_clip(self.cfg, wav)
        feat = self.extract_features(wav[None].astype(np.float32))
        ref = torch.from_numpy(np.ascontiguousarray(ref[None], np.float32)).to(self.device)
        semantic, glob = bicodec.tokenize(self.params, self.cfg, feat, ref)
        return glob.cpu().numpy(), semantic.cpu().numpy()

    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids (numpy, a list or a tensor) -> int64 on the codec's device."""
        return torch.as_tensor(tokens, device=self.device).long()

    def _global(self, global_tokens) -> torch.Tensor:
        g = self._tokens(global_tokens)
        return g[:, None, :] if g.dim() == 2 else g

    @torch.inference_mode()
    def detokenize(self, global_tokens, semantic_tokens) -> np.ndarray:
        """(B, Q, 32) x (B, T) -> wav (B, T hop) float32."""
        sem = self._tokens(semantic_tokens)
        wav = bicodec.detokenize(self.params, self.cfg, sem, self._global(global_tokens))
        return wav.cpu().numpy()

    @torch.inference_mode()
    def detokenize_rows(self, global_tokens, semantic_tokens, lengths: Sequence[int],
                        max_rows: int = 16) -> List[np.ndarray]:
        """Each row's first lengths[i] semantic tokens -> its wav (lengths[i]
        hops); rows of one length go through in batches of at most
        `max_rows` (the wave generator's activations grow with rows x
        samples). global (B, Q, 32) or (B, 32); semantic (B, T) with T >=
        every length."""
        glob, sem = self._global(global_tokens), self._tokens(semantic_tokens)
        out: List[np.ndarray] = [np.zeros(0, np.float32)] * len(lengths)
        by_len: Dict[int, List[int]] = {}
        for i, n in enumerate(lengths):
            if n > 0:
                by_len.setdefault(int(n), []).append(i)
        for n, rows in by_len.items():
            for s in range(0, len(rows), max_rows):
                idx = torch.tensor(rows[s:s + max_rows], device=self.device)
                wav = bicodec.detokenize(self.params, self.cfg, sem[idx, :n], glob[idx])
                for i, w in zip(rows[s:s + max_rows], wav.cpu().numpy()):
                    out[i] = w
        return out

"""XY_Tokenizer, the dual semantic + acoustic RVQ codec of the XY LM
(8 quantizers at 12.5 Hz; 16 kHz in, 24 kHz out), in PyTorch
(counterpart of rwkvtts_tpu/codecs/xy_tokenizer.py; the reference's
third_party/XY_Tokenizer/xy_tokenizer/model.py:13-279 and
nn/modules.py, nn/quantizer.py).

  encode: whisper log-mel (100 Hz) -> a semantic and an acoustic
    whisper-style encoder (conv stem, 50 Hz) -> the semantic adapter ->
    concatenated -> the pre-RVQ adapter -> SwiGLU down-sampling (x4, 12.5
    Hz) -> plain euclidean residual VQ -> codes (nq, B, T)
  decode: codes -> the RVQ sum -> the post-RVQ adapter -> transposed-conv
    up-sampling (50 Hz) -> the whisper-style decoder (deconvs, 100 Hz mel)
    -> the Vocos head (ConvNeXt backbone, magnitude / phase, an uncentred
    ISTFT trimmed "same") -> wav at 24 kHz, 1920 samples a code
  encode_long / decode_long: 30 s windows stepping by 20 s, each window's
    leading 20 s kept (the overlap is lookahead context), as the reference
    (model.py:131-256).

Plain functions on nested dicts of tensors, channels-last (B, T, C),
float32; the JAX package computes all of it in XLA, not in a kernel, and
so does the port: call it inside ``nn.f32()`` (TF32 off) for the JAX
package's precision. Parameters carry the JAX tree's names, with PyTorch's
convolution layouts (codecs/nn.py); ``bridge.xy_tokenizer_params_from_numpy``
converts a JAX tree, ``codecs/xy_import`` a reference checkpoint. The
S3 speech tokenizer shares the transformer layer and the log-mel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rwkvtts_torch.codecs import dsp, nn

Params = nn.Params


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    input_dim: int
    d_model: int
    output_dim: int
    layers: int
    heads: int
    ffn_dim: int
    max_positions: int = 1500


@dataclasses.dataclass(frozen=True)
class XYTokenizerConfig:
    input_sample_rate: int = 16000
    output_sample_rate: int = 24000
    n_mels: int = 80
    d_model: int = 768
    enc_layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    adapter_layers: int = 4
    avg_pooler: int = 4  # 50 Hz -> 12.5 Hz
    nq: int = 8
    codebook_size: int = 1024
    codebook_dim: int = 512
    rvq_dim: int = 512
    quantizer_io_dim: int = 3072  # d_model * avg_pooler
    dec_layers: int = 12
    vocos_dim: int = 512
    vocos_intermediate_dim: int = 4096
    vocos_layers: int = 30
    vocos_n_fft: int = 960
    vocos_hop: int = 240  # 100 Hz -> 24 kHz

    @property
    def frame_rate(self) -> float:
        return 12.5


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal positions (length, channels), sin then cos."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(sinusoids(x.shape[1], x.shape[2])).to(x)


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else x * mask[:, :, None]


# ---------------------------------------------------------------------------
# Whisper-style transformer layer (pre-LN, full attention over the valid frames)
# ---------------------------------------------------------------------------


def _tf_layer_init(g: torch.Generator, d: int, ffn: int) -> Params:
    dev = g.device
    return {
        "attn_ln": nn.layer_norm_init(d, dev),
        "q": nn.linear_init(g, d, d),
        "k": nn.linear_init(g, d, d, bias=False),
        "v": nn.linear_init(g, d, d),
        "out": nn.linear_init(g, d, d),
        "final_ln": nn.layer_norm_init(d, dev),
        "fc1": nn.linear_init(g, d, ffn),
        "fc2": nn.linear_init(g, ffn, d),
    }


def _tf_layer(p: Params, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """One pre-LN block; `mask` (B, T) > 0 marks the frames attended to."""
    B, T, D = x.shape
    dk = D // heads
    h = nn.layer_norm(p["attn_ln"], x, eps=1e-5)
    split = lambda y: y.reshape(B, T, heads, dk).transpose(1, 2)
    q, k, v = (split(nn.linear(p[n], h)) for n in ("q", "k", "v"))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dk)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores, -1e10)
    o = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(B, T, D)
    x = x + nn.linear(p["out"], o)
    h = nn.layer_norm(p["final_ln"], x, eps=1e-5)
    return x + nn.linear(p["fc2"], nn.gelu(nn.linear(p["fc1"], h)))


def _tf_stack_init(g: torch.Generator, layers: int, d: int, ffn: int) -> list:
    return [_tf_layer_init(g, d, ffn) for _ in range(layers)]


def _tf_stack(ps, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    for p in ps:
        x = _tf_layer(p, x, heads, mask)
    return x


# ---------------------------------------------------------------------------
# Audio encoder / decoder and the transformer adapters
# ---------------------------------------------------------------------------


def audio_encoder_init(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    d = cfg.d_model
    return {"conv1": nn.conv1d_init(g, cfg.n_mels, d, 3), "conv2": nn.conv1d_init(g, d, d, 3),
            "layers": _tf_stack_init(g, cfg.enc_layers, d, cfg.ffn_dim),
            "ln": nn.layer_norm_init(d, g.device)}


def audio_encoder(p: Params, cfg: XYTokenizerConfig, mel: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, T_mel, n_mels) at 100 Hz -> (B, T_mel / 2, d) at 50 Hz."""
    h = nn.gelu(nn.conv1d(p["conv1"], mel, padding=1))
    h = nn.gelu(nn.conv1d(p["conv2"], h, stride=2, padding=1))
    h = h + _positions(h)
    sub = mask[:, ::2][:, :h.shape[1]] if mask is not None else None
    h = _tf_stack(p["layers"], h, cfg.heads, sub)
    return _masked(nn.layer_norm(p["ln"], h, eps=1e-5), sub)


def adapter_init(g: torch.Generator, cfg: TransformerConfig) -> Params:
    p: Params = {"layers": _tf_stack_init(g, cfg.layers, cfg.d_model, cfg.ffn_dim),
                 "ln": nn.layer_norm_init(cfg.d_model, g.device)}
    if cfg.input_dim != cfg.d_model:
        p["proj"] = nn.linear_init(g, cfg.input_dim, cfg.d_model)
    if cfg.output_dim != cfg.d_model:
        p["out_proj"] = nn.linear_init(g, cfg.d_model, cfg.output_dim)
    return p


def adapter_apply(p: Params, cfg: TransformerConfig, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, input_dim) -> (B, T, output_dim)."""
    if "proj" in p:
        x = nn.linear(p["proj"], x)
    x = _tf_stack(p["layers"], x + _positions(x), cfg.heads, mask)
    x = _masked(nn.layer_norm(p["ln"], x, eps=1e-5), mask)
    return nn.linear(p["out_proj"], x) if "out_proj" in p else x


def audio_decoder_init(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    d = cfg.d_model
    return {"layers": _tf_stack_init(g, cfg.dec_layers, d, cfg.ffn_dim),
            "ln": nn.layer_norm_init(d, g.device),
            "deconv1": nn.conv_transpose1d_init(g, d, d, 3),
            "deconv2": nn.conv_transpose1d_init(g, d, cfg.n_mels, 3)}


def audio_decoder(p: Params, cfg: XYTokenizerConfig, h: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h (B, T, d) at 50 Hz -> (B, 2T, n_mels) at 100 Hz: deconv1 doubles
    the rate, deconv2 maps the channels."""
    T = h.shape[1]
    h = _tf_stack(p["layers"], h + _positions(h), cfg.heads, mask)
    h = _masked(nn.layer_norm(p["ln"], h, eps=1e-5), mask)
    y = nn.gelu(nn.conv_transpose1d(p["deconv1"], h, stride=2))
    y = nn.gelu(nn.conv_transpose1d(p["deconv2"], y, stride=1))
    return y[:, :2 * T]


# ---------------------------------------------------------------------------
# Residual down / up sampling (SwiGLU pooling)
# ---------------------------------------------------------------------------


def down_conv_init(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    d, pool = cfg.d_model, cfg.avg_pooler
    inter = d * pool
    return {"gate": nn.conv1d_init(g, d, inter, pool, bias=False),
            "up": nn.conv1d_init(g, d, inter, pool, bias=False),
            "down": nn.linear_init(g, inter, inter, bias=False),
            "ln": nn.layer_norm_init(inter, g.device)}


def down_conv(p: Params, cfg: XYTokenizerConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, d) at 50 Hz -> (B, T / pool, d pool) at 12.5 Hz, the input
    zero-padded to a multiple of pool (modules.py:451-478)."""
    pool = cfg.avg_pooler
    B, T, D = x.shape
    x = F.pad(x, (0, 0, 0, (-T) % pool))
    g = nn.conv1d(p["gate"], x, stride=pool, padding=0)
    u = nn.conv1d(p["up"], x, stride=pool, padding=0)
    c = nn.linear(p["down"], F.silu(g) * u)
    return nn.layer_norm(p["ln"], c + x.reshape(B, -1, D * pool), eps=1e-5)


def up_conv_init(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    d, s = cfg.d_model, cfg.avg_pooler
    return {"up": nn.conv_transpose1d_init(g, s * d, d, s, bias=False)}


def up_conv(p: Params, cfg: XYTokenizerConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, d s) -> (B, T s, d)."""
    return nn.conv_transpose1d(p["up"], x, stride=cfg.avg_pooler)


# ---------------------------------------------------------------------------
# Residual VQ (plain euclidean nearest code)
# ---------------------------------------------------------------------------


def rvq_init(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    p: Params = {"quantizers": []}
    if cfg.quantizer_io_dim != cfg.rvq_dim:
        p["input_proj"] = nn.linear_init(g, cfg.quantizer_io_dim, cfg.rvq_dim)
        p["output_proj"] = nn.linear_init(g, cfg.rvq_dim, cfg.quantizer_io_dim)
    for _ in range(cfg.nq):
        q: Params = {"codebook": torch.randn(cfg.codebook_size, cfg.codebook_dim, generator=g,
                                             device=g.device)}
        if cfg.rvq_dim != cfg.codebook_dim:
            q["in_project"] = nn.linear_init(g, cfg.rvq_dim, cfg.codebook_dim)
            q["out_project"] = nn.linear_init(g, cfg.codebook_dim, cfg.rvq_dim)
        p["quantizers"].append(q)
    return p


def _maybe(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return nn.linear(p[name], x) if name in p else x


def _nearest(codebook: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The nearest code of each row of z (B, T, D) by the JAX package's
    |z|^2 - 2 z.c + |c|^2."""
    d = ((z * z).sum(-1, keepdim=True) - 2 * z @ codebook.T
         + (codebook * codebook).sum(-1)[None, None, :])
    return torch.argmin(d, -1)


def rvq_encode(p: Params, cfg: XYTokenizerConfig, z: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, T, io_dim) -> (zq (B, T, io_dim), codes (nq, B, T))."""
    residual = _maybe(p, "input_proj", z)
    out = torch.zeros_like(residual)
    codes = []
    for q in p["quantizers"]:
        idx = _nearest(q["codebook"], _maybe(q, "in_project", residual))
        z_q = _maybe(q, "out_project", q["codebook"][idx])
        residual = residual - z_q
        out = out + z_q
        codes.append(idx)
    return _maybe(p, "output_proj", out), torch.stack(codes)


def rvq_decode(p: Params, cfg: XYTokenizerConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (nq, B, T) -> (B, T, io_dim)."""
    out = None
    for i in range(codes.shape[0]):
        q = p["quantizers"][i]
        z_q = _maybe(q, "out_project", q["codebook"][codes[i]])
        out = z_q if out is None else out + z_q
    return _maybe(p, "output_proj", out)


# ---------------------------------------------------------------------------
# Vocos head (ConvNeXt backbone + an ISTFT trimmed "same")
# ---------------------------------------------------------------------------


def vocos_init(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    return {"backbone": nn.vocos_backbone_init(g, cfg.n_mels, cfg.vocos_dim,
                                               cfg.vocos_intermediate_dim, cfg.vocos_layers),
            "head": nn.linear_init(g, cfg.vocos_dim, cfg.vocos_n_fft + 2)}


def vocos_apply(p: Params, cfg: XYTokenizerConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) at 100 Hz -> wav (B, T hop) at 24 kHz: magnitude
    exp(x) clipped at 100 and phase, the uncentred overlap-add trimmed by
    (n_fft - hop) / 2 at the start."""
    x = nn.linear(p["head"], nn.vocos_backbone(p["backbone"], mel))
    F_ = cfg.vocos_n_fft // 2 + 1
    mag = torch.clamp(torch.exp(x[..., :F_]), max=1e2)
    phase = x[..., F_:]
    pad = (cfg.vocos_n_fft - cfg.vocos_hop) // 2
    wav = dsp.istft(mag * torch.cos(phase), mag * torch.sin(phase), cfg.vocos_n_fft,
                    cfg.vocos_hop, center=False)
    return wav[..., pad:pad + mel.shape[1] * cfg.vocos_hop]


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------


def _adapter_cfgs(cfg: XYTokenizerConfig):
    d, n, h, f = cfg.d_model, cfg.adapter_layers, cfg.heads, cfg.ffn_dim
    return (TransformerConfig(d, d, d, n, h, f), TransformerConfig(2 * d, d, d, n, h, f),
            TransformerConfig(cfg.quantizer_io_dim, d, cfg.quantizer_io_dim, n, h, f))


def init_params(g: torch.Generator, cfg: XYTokenizerConfig) -> Params:
    """f32 parameters drawn from `g`, on its device (the JAX package's tree,
    shapes and distributions; other values)."""
    sem, pre, post = _adapter_cfgs(cfg)
    return {
        "semantic_encoder": audio_encoder_init(g, cfg),
        "semantic_adapter": adapter_init(g, sem),
        "acoustic_encoder": audio_encoder_init(g, cfg),
        "pre_rvq_adapter": adapter_init(g, pre),
        "downsample": down_conv_init(g, cfg),
        "quantizer": rvq_init(g, cfg),
        "post_rvq_adapter": adapter_init(g, post),
        "upsample": up_conv_init(g, cfg),
        "acoustic_decoder": audio_decoder_init(g, cfg),
        "vocos": vocos_init(g, cfg),
    }


def encode(p: Params, cfg: XYTokenizerConfig, mel: torch.Tensor,
           mel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, T_mel, n_mels), the whisper log-mel at 100 Hz -> codes (nq,
    B, T_mel / 8)."""
    sem_cfg, pre_cfg, _ = _adapter_cfgs(cfg)
    sub = mel_mask[:, ::2] if mel_mask is not None else None
    sem = adapter_apply(p["semantic_adapter"], sem_cfg,
                        audio_encoder(p["semantic_encoder"], cfg, mel, mel_mask), sub)
    aco = audio_encoder(p["acoustic_encoder"], cfg, mel, mel_mask)
    h = adapter_apply(p["pre_rvq_adapter"], pre_cfg, torch.cat([sem, aco], -1), sub)
    return rvq_encode(p["quantizer"], cfg, down_conv(p["downsample"], cfg, h))[1]


def decode(p: Params, cfg: XYTokenizerConfig, codes: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes (nq, B, T) at 12.5 Hz -> wav (B, T 8 hop) at 24 kHz."""
    post_cfg = _adapter_cfgs(cfg)[2]
    h = adapter_apply(p["post_rvq_adapter"], post_cfg, rvq_decode(p["quantizer"], cfg, codes),
                      mask)
    mel = audio_decoder(p["acoustic_decoder"], cfg, up_conv(p["upsample"], cfg, h))
    return vocos_apply(p["vocos"], cfg, mel)


def whisper_log_mel(wav: torch.Tensor, sample_rate: int = 16000, n_fft: int = 400,
                    hop: int = 160, n_mels: int = 80) -> torch.Tensor:
    """Whisper's log-mel: the centred STFT's power without its last frame,
    the slaney mel, log10(clamp(mel, 1e-10)) clamped to within 8 of its
    maximum, then (x + 4) / 4. wav (B, T) -> (B, T // hop, n_mels)."""
    real, imag = dsp.stft(wav, n_fft, hop)
    real, imag = real[:, :-1], imag[:, :-1]
    power = real ** 2 + imag ** 2
    fb = torch.from_numpy(dsp.mel_filterbank(sample_rate, n_fft, n_mels, 0.0, None))
    log_spec = torch.log10(torch.clamp_min(power @ fb.to(power), 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Long audio: fixed windows of window_seconds stepping by window - overlap,
# each window's leading (window - overlap) kept; every window has the same
# shape (zero-padded and masked), so a card sees one shape
# ---------------------------------------------------------------------------

_SAMPLES_PER_CODE = 8 * 160  # 8 mel frames (100 Hz at 16 kHz) a 12.5 Hz code


def _device(p: Params) -> torch.device:
    return p["quantizer"]["quantizers"][0]["codebook"].device


def encode_long(p: Params, cfg: XYTokenizerConfig, wav, window_seconds: float = 30.0,
                overlap_seconds: float = 10.0) -> np.ndarray:
    """wav (T,) at 16 kHz, any length -> codes (nq, T // 1280) (numpy),
    on the parameters' device."""
    wav = np.asarray(wav, np.float32)
    dev = _device(p)
    sr = cfg.input_sample_rate
    win = int(window_seconds * sr)
    dur = int((window_seconds - overlap_seconds) * sr)
    keep_codes = dur // _SAMPLES_PER_CODE
    total_codes = len(wav) // _SAMPLES_PER_CODE
    mel_of = lambda a: whisper_log_mel(torch.from_numpy(a[None]).to(dev), n_mels=cfg.n_mels)
    if len(wav) <= win:
        return encode(p, cfg, mel_of(wav)).cpu().numpy()[:, 0, :total_codes]
    chunks = []
    for start in range(0, len(wav), dur):
        piece = wav[start:start + win]
        n = len(piece)
        buf = np.zeros(win, np.float32)
        buf[:n] = piece
        mel = mel_of(buf)
        mask = torch.from_numpy((np.arange(mel.shape[1]) * 160 < n).astype(np.float32)[None])
        codes = encode(p, cfg, mel, mask.to(dev)).cpu().numpy()[:, 0]
        valid = min(keep_codes, n // _SAMPLES_PER_CODE)
        if valid > 0:
            chunks.append(codes[:, :valid])
    return np.concatenate(chunks, -1)[:, :total_codes]


def decode_long(p: Params, cfg: XYTokenizerConfig, codes, window_seconds: float = 30.0,
                overlap_seconds: float = 10.0) -> np.ndarray:
    """codes (nq, T), any length -> wav (T 8 hop,) at 24 kHz (numpy), on the
    parameters' device."""
    codes = np.asarray(codes)
    dev = _device(p)
    win = int(window_seconds * cfg.frame_rate)
    keep = int((window_seconds - overlap_seconds) * cfg.frame_rate)
    out_per_code = 8 * cfg.vocos_hop
    T = codes.shape[-1]
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if T <= win:
        return decode(p, cfg, on_dev(codes[:, None, :])).cpu().numpy()[0]
    pieces = []
    for start in range(0, T, keep):
        piece = codes[:, start:start + win]
        n = piece.shape[-1]
        buf = np.zeros((codes.shape[0], win), codes.dtype)
        buf[:, :n] = piece
        mask = on_dev((np.arange(win) < n).astype(np.float32)[None])
        wav = decode(p, cfg, on_dev(buf[:, None, :]), mask).cpu().numpy()[0]
        valid = min(keep, n) * out_per_code
        if valid > 0:
            pieces.append(wav[:valid])
    return np.concatenate(pieces)[:T * out_per_code]

"""BiCodec, the Spark-TTS audio codec (counterpart of
rwkvtts_tpu/codecs/bicodec.py).

Tokens <-> waveform for the Spark route:
  * semantic tokens: a factorized VQ over wav2vec2 features, 8192 codes at
    50 Hz;
  * global (speaker) tokens: ECAPA-TDNN -> perceiver -> residual FSQ, 32
    an utterance, 4096 ids (levels [4] * 6).
``detokenize`` runs the VQ codebook, the speaker code's projection, the
prenet (a conditioned Vocos stack) and the DAC-style wave generator (the
postnet is not on that path); ``tokenize`` runs the encoder and the VQ on
wav2vec2 features and the speaker encoder on the mel of a reference clip.

Precision: the codec computes in float32 with TF32 off (``nn.f32``),
for its convolutions and its products alike, as the JAX package computes
it: on a card, PyTorch would otherwise run f32 convolutions as TF32 (10
mantissa bits), and the nearest-code search and FSQ rounding would see it.

Everything is channels-last (B, T, C) and functional over nested-dict
parameters with the JAX tree's names, in PyTorch's weight layouts
(codecs/nn.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rwkvtts_torch.codecs import dsp, nn, quantizers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MelParams:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 640
    hop_length: int = 320
    mel_fmin: float = 10.0
    mel_fmax: Optional[float] = None
    num_mels: int = 128


@dataclasses.dataclass(frozen=True)
class VocosStackConfig:
    """The shape of the Encoder and of the Decoder (prenet / postnet)."""

    input_channels: int
    vocos_dim: int
    vocos_intermediate_dim: int
    vocos_num_layers: int
    out_channels: int
    sample_ratios: Tuple[int, ...] = (1, 1)
    condition_dim: Optional[int] = None
    use_tanh_at_final: bool = False


@dataclasses.dataclass(frozen=True)
class WaveGeneratorConfig:
    input_channel: int = 1024
    channels: int = 1536
    rates: Tuple[int, ...] = (8, 5, 4, 2)
    kernel_sizes: Tuple[int, ...] = (16, 11, 8, 4)
    d_out: int = 1


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    input_dim: int = 128  # mel bins
    out_dim: int = 1024
    latent_dim: int = 128
    token_num: int = 32
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4)
    fsq_num_quantizers: int = 1
    ecapa_channels: int = 512


@dataclasses.dataclass(frozen=True)
class BiCodecConfig:
    """Defaults: the published Spark-TTS-0.5B BiCodec."""

    mel: MelParams = MelParams()
    encoder: VocosStackConfig = VocosStackConfig(1024, 384, 2048, 12, 1024)
    quantizer_codebook_size: int = 8192
    quantizer_codebook_dim: int = 8
    quantizer_input_dim: int = 1024
    quantizer_commitment: float = 0.25
    prenet: VocosStackConfig = VocosStackConfig(1024, 384, 2048, 12, 1024, condition_dim=1024)
    postnet: VocosStackConfig = VocosStackConfig(1024, 384, 2048, 6, 128)
    wave: WaveGeneratorConfig = WaveGeneratorConfig()
    speaker: SpeakerEncoderConfig = SpeakerEncoderConfig()
    ref_segment_duration: float = 6.0
    latent_hop_length: int = 320


# ---------------------------------------------------------------------------
# Encoder / Decoder (Vocos stacks with sampling blocks)
# ---------------------------------------------------------------------------


def _vocos_stack_init(g: torch.Generator, cfg: VocosStackConfig, is_encoder: bool) -> Params:
    d = cfg.vocos_dim
    p: Params = {}
    if is_encoder:
        p["backbone"] = nn.vocos_backbone_init(g, cfg.input_channels, d,
                                               cfg.vocos_intermediate_dim, cfg.vocos_num_layers)
        p["project"] = nn.linear_init(g, d, cfg.out_channels)
    else:
        p["linear_pre"] = nn.linear_init(g, cfg.input_channels, d)
        p["backbone"] = nn.vocos_backbone_init(g, d, d, cfg.vocos_intermediate_dim,
                                               cfg.vocos_num_layers, cond_dim=cfg.condition_dim)
        p["linear"] = nn.linear_init(g, d, cfg.out_channels)
    p["samplers"] = [
        {"block": nn.sampling_block_init(g, d, groups=d,
                                         downsample_scale=r if is_encoder else 1,
                                         upsample_scale=1 if is_encoder else r),
         "vocos": nn.vocos_backbone_init(g, d, d, cfg.vocos_intermediate_dim, 2)}
        for r in cfg.sample_ratios]
    return p


def encoder_apply(p: Params, cfg: VocosStackConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, input_channels), wav2vec2 features -> (B, T', out_channels)."""
    x = nn.vocos_backbone(p["backbone"], x)
    for s, r in zip(p["samplers"], cfg.sample_ratios):
        x = nn.sampling_block(s["block"], x, groups=cfg.vocos_dim, downsample_scale=r)
        x = nn.vocos_backbone(s["vocos"], x)
    return nn.linear(p["project"], x)


def decoder_apply(p: Params, cfg: VocosStackConfig, x: torch.Tensor, cond=None) -> torch.Tensor:
    """The reference's Decoder (prenet / postnet): (B, T, in) -> (B, T', out)."""
    x = nn.linear(p["linear_pre"], x)
    for s, r in zip(p["samplers"], cfg.sample_ratios):
        x = nn.sampling_block(s["block"], x, groups=cfg.vocos_dim, upsample_scale=r)
        x = nn.vocos_backbone(s["vocos"], x)
    x = nn.linear(p["linear"], nn.vocos_backbone(p["backbone"], x, cond))
    return torch.tanh(x) if cfg.use_tanh_at_final else x


# ---------------------------------------------------------------------------
# Wave generator (DAC-style decoder)
# ---------------------------------------------------------------------------

_DILATIONS = (1, 3, 9)


def _residual_unit(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = nn.conv1d(p["conv1"], nn.snake(p["snake1"], x), dilation=dilation,
                  padding=3 * dilation)
    y = nn.conv1d(p["conv2"], nn.snake(p["snake2"], y), padding=0)
    return x + y


def wave_generator_init(g: torch.Generator, cfg: WaveGeneratorConfig) -> Params:
    dev = g.device
    p: Params = {"conv_in": nn.conv1d_init(g, cfg.input_channel, cfg.channels, 7, std=0.02),
                 "blocks": []}
    out_dim = cfg.channels
    for i, ksz in enumerate(cfg.kernel_sizes):
        in_dim, out_dim = cfg.channels // 2 ** i, cfg.channels // 2 ** (i + 1)
        p["blocks"].append({
            "snake": nn.snake_init(in_dim, dev),
            "up": nn.conv_transpose1d_init(g, in_dim, out_dim, ksz),
            "res": [{"snake1": nn.snake_init(out_dim, dev),
                     "conv1": nn.conv1d_init(g, out_dim, out_dim, 7),
                     "snake2": nn.snake_init(out_dim, dev),
                     "conv2": nn.conv1d_init(g, out_dim, out_dim, 1)} for _ in _DILATIONS],
        })
    p["snake_out"] = nn.snake_init(out_dim, dev)
    p["conv_out"] = nn.conv1d_init(g, out_dim, cfg.d_out, 7, std=0.02)
    return p


def wave_generator_apply(p: Params, cfg: WaveGeneratorConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, input_channel) -> wav (B, T prod(rates)): each block's
    transposed convolution, padding (K - stride) // 2, gives T x stride."""
    x = nn.conv1d(p["conv_in"], x, padding=3)
    for blk, ksz, stride in zip(p["blocks"], cfg.kernel_sizes, cfg.rates):
        x = nn.conv_transpose1d(blk["up"], nn.snake(blk["snake"], x), stride=stride,
                                padding=(ksz - stride) // 2)
        for res, d in zip(blk["res"], _DILATIONS):
            x = _residual_unit(res, x, d)
    x = nn.conv1d(p["conv_out"], nn.snake(p["snake_out"], x), padding=3)
    return torch.tanh(x)[..., 0]


# ---------------------------------------------------------------------------
# ECAPA-TDNN (GLOB_c512), the speaker feature extractor
# ---------------------------------------------------------------------------


def _conv_relu_bn_init(g: torch.Generator, in_ch: int, out_ch: int, k: int) -> Params:
    return {"conv": nn.conv1d_init(g, in_ch, out_ch, k), "bn": nn.batch_norm_init(out_ch, g.device)}


def _conv_relu_bn(p: Params, x: torch.Tensor, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    return nn.batch_norm(p["bn"], F.relu(nn.conv1d(p["conv"], x, padding=padding,
                                                    dilation=dilation)))


def _se_res2block_init(g: torch.Generator, channels: int, scale: int = 8) -> Params:
    width = channels // scale
    return {
        "in": _conv_relu_bn_init(g, channels, channels, 1),
        "res2": [{"conv": nn.conv1d_init(g, width, width, 3),
                  "bn": nn.batch_norm_init(width, g.device)} for _ in range(scale - 1)],
        "out": _conv_relu_bn_init(g, channels, channels, 1),
        "se1": nn.linear_init(g, channels, 128),
        "se2": nn.linear_init(g, 128, channels),
    }


def _se_res2block(p: Params, x: torch.Tensor, dilation: int, scale: int = 8) -> torch.Tensor:
    """Res2: the channels in `scale` groups, each group after the first
    convolved with the running sum of the previous output; the last group
    passes through; then squeeze-excitation and the residual."""
    res = x
    x = _conv_relu_bn(p["in"], x)
    groups = x.chunk(scale, -1)
    out, sp = [], groups[0]
    for i, layer in enumerate(p["res2"]):
        if i >= 1:
            sp = sp + groups[i]
        sp = nn.batch_norm(layer["bn"], F.relu(nn.conv1d(layer["conv"], sp, padding=dilation,
                                                         dilation=dilation)))
        out.append(sp)
    out.append(groups[-1])
    x = _conv_relu_bn(p["out"], torch.cat(out, -1))
    s = torch.sigmoid(nn.linear(p["se2"], F.relu(nn.linear(p["se1"], x.mean(1)))))
    return res + x * s[:, None]


def ecapa_init(g: torch.Generator, feat_dim: int, channels: int = 512, embed_dim: int = 1024
               ) -> Params:
    out_channels = 512 * 3
    return {
        "layer1": _conv_relu_bn_init(g, feat_dim, channels, 5),
        "layer2": _se_res2block_init(g, channels),
        "layer3": _se_res2block_init(g, channels),
        "layer4": _se_res2block_init(g, channels),
        "conv": nn.conv1d_init(g, channels * 3, out_channels, 1),
        # global-context attentive statistics pooling (the GLOB variant)
        "astp1": nn.conv1d_init(g, out_channels * 3, 128, 1),
        "astp2": nn.conv1d_init(g, 128, out_channels, 1),
        "bn": nn.batch_norm_init(out_channels * 2, g.device),
        "linear": nn.linear_init(g, out_channels * 2, embed_dim),
    }


def ecapa_apply(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, feat_dim) -> (x-vector (B, embed), latent (B, T, 1536))."""
    out1 = _conv_relu_bn(p["layer1"], x, padding=2)
    out2 = _se_res2block(p["layer2"], out1, dilation=2)
    out3 = _se_res2block(p["layer3"], out2, dilation=3)
    out4 = _se_res2block(p["layer4"], out3, dilation=4)
    latent = F.relu(nn.conv1d(p["conv"], torch.cat([out2, out3, out4], -1), padding=0))
    # attention over time from each frame beside the utterance's mean and std
    mean_c = latent.mean(1, keepdim=True)
    std_c = torch.sqrt(latent.var(1, unbiased=False, keepdim=True) + 1e-7)
    x_in = torch.cat([latent, mean_c.expand_as(latent), std_c.expand_as(latent)], -1)
    alpha = torch.tanh(nn.conv1d(p["astp1"], x_in, padding=0))
    alpha = torch.softmax(nn.conv1d(p["astp2"], alpha, padding=0), 1)
    mean = (alpha * latent).sum(1)
    var = (alpha * latent ** 2).sum(1) - mean ** 2
    stats = torch.cat([mean, torch.sqrt(var.clamp_min(1e-7))], -1)
    return nn.linear(p["linear"], nn.batch_norm(p["bn"], stats)), latent


# ---------------------------------------------------------------------------
# Speaker encoder (ECAPA -> perceiver -> residual FSQ -> projection)
# ---------------------------------------------------------------------------


def speaker_encoder_init(g: torch.Generator, cfg: SpeakerEncoderConfig) -> Params:
    return {
        "ecapa": ecapa_init(g, cfg.input_dim, cfg.ecapa_channels, cfg.out_dim),
        "perceiver": nn.perceiver_resampler_init(g, dim=cfg.latent_dim, dim_context=512 * 3,
                                                 num_latents=cfg.token_num),
        "fsq": quantizers.residual_fsq_init(g, cfg.latent_dim, cfg.fsq_levels),
        "project": nn.linear_init(g, cfg.latent_dim * cfg.token_num, cfg.out_dim),
    }


def _flatten_zq(zq: torch.Tensor) -> torch.Tensor:
    """(B, N, D) -> (B, D N) in the reference's order: its zq is (B, D, N),
    so the flatten walks D, then N."""
    return zq.transpose(1, 2).reshape(zq.shape[0], -1)


def speaker_encoder_tokenize(p: Params, cfg: SpeakerEncoderConfig, mels: torch.Tensor
                             ) -> torch.Tensor:
    """mels (B, T, num_mels) -> global token ids (B, Q, token_num)."""
    _, latent = ecapa_apply(p["ecapa"], mels)
    x = nn.perceiver_resampler(p["perceiver"], latent)
    _, idx = quantizers.residual_fsq_forward(p["fsq"], x, cfg.fsq_levels, cfg.fsq_num_quantizers)
    return idx.transpose(1, 2)


def speaker_encoder_detokenize(p: Params, cfg: SpeakerEncoderConfig, indices: torch.Tensor
                               ) -> torch.Tensor:
    """indices (B, Q, token_num) -> d-vector (B, out_dim)."""
    zq = quantizers.residual_fsq_output_from_indices(p["fsq"], indices.transpose(1, 2),
                                                     cfg.fsq_levels, cfg.fsq_num_quantizers)
    return nn.linear(p["project"], _flatten_zq(zq))


# ---------------------------------------------------------------------------
# BiCodec
# ---------------------------------------------------------------------------


def init_params(g: torch.Generator, cfg: BiCodecConfig) -> Params:
    """f32 parameters drawn from `g`, on the generator's device (the JAX
    tree, shapes and distributions; other values)."""
    return {
        "encoder": _vocos_stack_init(g, cfg.encoder, is_encoder=True),
        "quantizer": quantizers.factorized_vq_init(
            g, cfg.quantizer_input_dim, cfg.quantizer_codebook_size, cfg.quantizer_codebook_dim),
        "speaker_encoder": speaker_encoder_init(g, cfg.speaker),
        "prenet": _vocos_stack_init(g, cfg.prenet, is_encoder=False),
        "postnet": _vocos_stack_init(g, cfg.postnet, is_encoder=False),
        "decoder": wave_generator_init(g, cfg.wave),
    }


def ref_mel(cfg: BiCodecConfig, ref_wav: torch.Tensor) -> torch.Tensor:
    """ref_wav (B, T) -> (B, frames, num_mels)."""
    m = cfg.mel
    with nn.f32():
        return dsp.mel_spectrogram(ref_wav, m.sample_rate, m.n_fft, m.win_length, m.hop_length,
                                   m.num_mels, m.mel_fmin, m.mel_fmax)


def tokenize(p: Params, cfg: BiCodecConfig, feat: torch.Tensor, ref_wav: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat (B, T, 1024) wav2vec2 features; ref_wav (B, Tr) the reference
    clip. Returns (semantic tokens (B, T'), global tokens (B, Q, 32))."""
    with nn.f32():
        z = encoder_apply(p["encoder"], cfg.encoder, feat)
        semantic = quantizers.factorized_vq_tokenize(p["quantizer"], z)
        glob = speaker_encoder_tokenize(p["speaker_encoder"], cfg.speaker, ref_mel(cfg, ref_wav))
    return semantic, glob


def detokenize(p: Params, cfg: BiCodecConfig, semantic_tokens: torch.Tensor,
               global_tokens: torch.Tensor) -> torch.Tensor:
    """semantic (B, T); global (B, Q, 32) -> wav (B, T hop)."""
    with nn.f32():
        z_q = quantizers.factorized_vq_detokenize(p["quantizer"], semantic_tokens)
        d_vector = speaker_encoder_detokenize(p["speaker_encoder"], cfg.speaker, global_tokens)
        x = decoder_apply(p["prenet"], cfg.prenet, z_q, d_vector) + d_vector[:, None]
        return wave_generator_apply(p["decoder"], cfg.wave, x)


def get_ref_clip(cfg: BiCodecConfig, wav: np.ndarray) -> np.ndarray:
    """The reference clip of a prompt: its first ref_segment_duration
    seconds in whole latent hops, the wav tiled when shorter."""
    ref_len = (int(cfg.mel.sample_rate * cfg.ref_segment_duration)
               // cfg.latent_hop_length * cfg.latent_hop_length)
    if ref_len > len(wav):
        wav = np.tile(wav, ref_len // len(wav) + 1)
    return wav[:ref_len]

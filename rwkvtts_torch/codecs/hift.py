"""HiFT vocoder: NSF harmonic source + HiFi-GAN upsampling + ISTFT head
(counterpart of rwkvtts_tpu/codecs/hift.py; reference
third_party/cosyvoice/hifigan/generator.py): mel -> f0 -> sine source ->
STFT(source) fused into the upsampling stack -> conv_post -> (log
magnitude, phase) -> ISTFT -> wav. The 24 kHz CosyVoice2 configuration
is the default. Channels-last.

The sine source draws a random initial phase a harmonic and Gaussian
noise: pass them in (``phase``, ``noise``) or a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rwkvtts_torch.codecs import dsp, nn

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        r = self.istft_hop_len
        for u in self.upsample_rates:
            r *= u
        return r

    @property
    def source_down_rates(self) -> Tuple[int, ...]:
        """Stride of each source-fusion conv: the cumulative upsampling still
        to come after stage i."""
        down = [1] + list(self.upsample_rates[::-1][:-1])
        return tuple(int(u) for u in np.cumprod(down)[::-1])


# ---------------------------------------------------------------------------
# F0 predictor and sine source
# ---------------------------------------------------------------------------


def f0_predict(p: Params, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, T, 80) -> f0 (B, T) in Hz (ConvRNNF0Predictor)."""
    h = mel
    for c in p["convs"]:
        h = F.elu(nn.conv1d(c, h, padding=1))
    return nn.linear(p["classifier"], h).abs()[..., 0]


def source_draws(cfg: HiFTConfig, batch: int, n_samples: int, generator: torch.Generator,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sine source's random inputs: phase (B, H, 1) uniform in
    (-pi, pi) and noise (B, H, T) standard normal."""
    H = cfg.nb_harmonics + 1
    phase = (torch.rand(batch, H, 1, generator=generator) * 2 - 1) * np.pi
    noise = torch.randn(batch, H, n_samples, generator=generator)
    return phase.to(device), noise.to(device)


def sine_source(p: Params, cfg: HiFTConfig, f0_up: torch.Tensor, phase: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """f0_up (B, T) upsampled f0 -> merged sine source (B, T, 1)
    (generator.py:138-168): per-harmonic cumulative phase plus a random
    initial phase (none for the fundamental), voiced / unvoiced gating with
    noise."""
    H = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, H + 1, dtype=f0_up.dtype, device=f0_up.device)
    F_mat = f0_up[:, None, :] * harmonics[None, :, None] / cfg.sampling_rate
    theta = 2 * np.pi * torch.remainder(torch.cumsum(F_mat, -1), 1.0)
    phase = phase.clone()
    phase[:, 0] = 0.0
    sines = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).to(f0_up.dtype)[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1 - uv) * cfg.nsf_alpha / 3
    sines = sines * uv + noise_amp * noise
    return torch.tanh(nn.linear(p["l_linear"], sines.transpose(1, 2)))


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


def _resblock_init(g, channels, kernel, dilations) -> Params:
    n = len(dilations)
    return {"convs1": [nn.conv1d_init(g, channels, channels, kernel) for _ in range(n)],
            "convs2": [nn.conv1d_init(g, channels, channels, kernel) for _ in range(n)],
            "act1": [nn.snake_init(channels, g.device) for _ in range(n)],
            "act2": [nn.snake_init(channels, g.device) for _ in range(n)]}


def _resblock(p, x, kernel, dilations):
    for i, d in enumerate(dilations):
        xt = nn.conv1d(p["convs1"][i], nn.snake(p["act1"][i], x), dilation=d,
                       padding=(kernel * d - d) // 2)
        xt = nn.conv1d(p["convs2"][i], nn.snake(p["act2"][i], xt), padding=(kernel - 1) // 2)
        x = x + xt
    return x


def init_params(g: torch.Generator, cfg: HiFTConfig) -> Params:
    ch_f0 = cfg.f0_cond_channels
    nfft2 = cfg.istft_n_fft + 2
    p: Params = {
        "f0_predictor": {
            "convs": [nn.conv1d_init(g, cfg.in_channels if i == 0 else ch_f0, ch_f0, 3)
                      for i in range(5)],
            "classifier": nn.linear_init(g, ch_f0, 1),
        },
        "m_source": {"l_linear": nn.linear_init(g, cfg.nb_harmonics + 1, 1)},
        "conv_pre": nn.conv1d_init(g, cfg.in_channels, cfg.base_channels, 7),
        "ups": [], "source_downs": [], "source_resblocks": [], "resblocks": [],
    }
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        p["ups"].append(nn.conv_transpose1d_init(
            g, cfg.base_channels // 2 ** i, cfg.base_channels // 2 ** (i + 1), k))
    for i, (u, k, d) in enumerate(zip(cfg.source_down_rates, cfg.source_resblock_kernel_sizes,
                                      cfg.source_resblock_dilation_sizes)):
        ch = cfg.base_channels // 2 ** (i + 1)
        p["source_downs"].append(nn.conv1d_init(g, nfft2, ch, 1 if u == 1 else 2 * u))
        p["source_resblocks"].append(_resblock_init(g, ch, k, d))
    for i in range(len(cfg.upsample_rates)):
        ch = cfg.base_channels // 2 ** (i + 1)
        for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            p["resblocks"].append(_resblock_init(g, ch, k, d))
    p["conv_post"] = nn.conv1d_init(g, ch, nfft2, 7)
    return p


def decode(p: Params, cfg: HiFTConfig, mel: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """mel (B, T, 80), source (B, T * total_upsample) -> wav (B, T * total_upsample)."""
    real, imag = dsp.stft(source, cfg.istft_n_fft, cfg.istft_hop_len)
    s_stft = torch.cat([real, imag], -1)
    x = nn.conv1d(p["conv_pre"], mel, padding=3)
    n_up, n_k = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        x = nn.leaky_relu(x, cfg.lrelu_slope)
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        x = nn.conv_transpose1d(p["ups"][i], x, stride=u, padding=(k - u) // 2)
        if i == n_up - 1:
            x = torch.cat([x[:, 1:2], x], 1)  # reflection pad (1, 0) on time
        uu = cfg.source_down_rates[i]
        si = (nn.conv1d(p["source_downs"][i], s_stft, padding=0) if uu == 1 else
              nn.conv1d(p["source_downs"][i], s_stft, stride=uu, padding=uu // 2))
        si = _resblock(p["source_resblocks"][i], si, cfg.source_resblock_kernel_sizes[i],
                       cfg.source_resblock_dilation_sizes[i])
        L = min(x.shape[1], si.shape[1])
        x = x[:, :L] + si[:, :L]
        xs = None
        for j in range(n_k):
            r = _resblock(p["resblocks"][i * n_k + j], x, cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilation_sizes[j])
            xs = r if xs is None else xs + r
        x = xs / n_k
    x = nn.conv1d(p["conv_post"], nn.leaky_relu(x, 0.01), padding=3)
    F_ = cfg.istft_n_fft // 2 + 1
    magnitude = torch.clamp(torch.exp(x[..., :F_]), max=1e2)
    phase = torch.sin(x[..., F_:])  # the reference applies sin here (generator.py:380)
    wav = dsp.istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase),
                    cfg.istft_n_fft, cfg.istft_hop_len)
    return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)


def inference(p: Params, cfg: HiFTConfig, mel: torch.Tensor,
              cache_source: Optional[torch.Tensor] = None, *,
              phase: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel (B, T, 80) -> (wav (B, T * total_upsample), source). The source
    starts with `cache_source` (B, Ts), the previous hop's tail, for a
    glitch-free continuation (generator.py:407-412). The sine source's
    draws are `phase` and `noise` (see ``source_draws``), or drawn from
    `generator`."""
    f0_up = torch.repeat_interleave(f0_predict(p["f0_predictor"], mel), cfg.total_upsample, 1)
    if phase is None or noise is None:
        if generator is None:
            raise ValueError("hift.inference: pass `phase` and `noise` or a `generator`")
        phase, noise = source_draws(cfg, mel.shape[0], f0_up.shape[1], generator, mel.device)
    s = sine_source(p["m_source"], cfg, f0_up, phase.to(mel), noise.to(mel))[..., 0]
    if cache_source is not None and cache_source.shape[1] > 0:
        s = torch.cat([cache_source.to(s), s[:, cache_source.shape[1]:]], 1)
    return decode(p, cfg, mel, s), s

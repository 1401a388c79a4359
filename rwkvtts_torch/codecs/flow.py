"""Flow-matching mel generator of the CosyVoice path (counterpart of
rwkvtts_tpu/codecs/flow.py; reference third_party/cosyvoice/flow/flow.py,
flow_matching.py, decoder.py): the x-vector affine, the token encoder
(upsample conformer), the estimator UNet (the deployed causal form, or
with ``EstimatorConfig.causal=False`` the non-causal one: GroupNorm(8)
blocks and padding-1 convolutions), the 10-step Euler CFM
solve with classifier-free guidance, and the windowed streaming hop.

The initial CFM noise is a function of (seed, absolute mel frame), so a
windowed hop sees at its frames exactly the noise the full sequence would.
The JAX package folds the frame index into a key; the port draws a table
over absolute frames once (``NoiseTable``) and indexes it with the same
absolute-index formula. Every noise input can be passed in explicitly.
The SFM fast path (``sfm_inference`` and its windowed hop,
model/flow/flow.py:132-180 of the reference) starts the ODE at the SFM
head's coarse prediction. The training losses: ``cfm_loss`` (the plain
CFM objective, flow_matching.py:145-185) and ``sfm_loss`` (the four-term
SFM objective, model/flow/flow.py:64-121); their random draws come from a
``torch.Generator`` or are passed in. Channels-last (B, T, C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rwkvtts_torch.codecs import conformer, nn
from rwkvtts_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    in_channels: int = 320  # 80 x + 80 mu + 80 spk + 80 cond (cosy2)
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    attention_head_dim: int = 64
    # causal: LayerNorm blocks behind left-padded convolutions; otherwise
    # GroupNorm(8) blocks and symmetric padding-1 convolutions
    causal: bool = True
    static_chunk_size: int = 0  # 0 => full attention (offline)


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    sigma_min: float = 1e-6
    inference_cfg_rate: float = 0.7  # classifier-free guidance


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    encoder: conformer.UpsampleConformerConfig = conformer.UpsampleConformerConfig()
    estimator: EstimatorConfig = EstimatorConfig()
    cfm: CFMConfig = CFMConfig()
    n_timesteps: int = 10
    # the SFM flow: an SFM head whose coarse prediction starts the ODE late
    sfm: bool = False
    sfm_strength: float = 2.5


# ---------------------------------------------------------------------------
# Estimator (matcha / diffusers style, channels-last)
# ---------------------------------------------------------------------------


def _sinusoidal_t_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=t.device, dtype=t.dtype)
                      * -(math.log(10000.0) / (half - 1)))
    ang = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _block1d_init(g, dim, dim_out, causal: bool) -> Params:
    norm = nn.layer_norm_init(dim_out, g.device)
    return {"conv": nn.conv1d_init(g, dim, dim_out, 3), ("ln" if causal else "gn"): norm}


def _group_norm8(p, x):
    """GroupNorm(8) over channels-last (B, T, C), statistics over every
    frame (the mask does not enter them, as in the JAX package)."""
    B, T, C = x.shape
    xg = x.reshape(B, T, 8, C // 8)
    mu = xg.mean((1, 3), keepdim=True)
    var = xg.var((1, 3), unbiased=False, keepdim=True)
    return ((xg - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, C) * p["g"] + p["b"]


def _block1d(p, x, mask, causal: bool):
    if causal:
        x = nn.layer_norm(p["ln"], nn.conv1d(p["conv"], x * mask, padding=(2, 0)), eps=1e-5)
    else:
        x = _group_norm8(p["gn"], nn.conv1d(p["conv"], x * mask, padding=1))
    return F.mish(x) * mask


def _resnet_block_init(g, dim, dim_out, time_dim, causal: bool) -> Params:
    return {"mlp": nn.linear_init(g, time_dim, dim_out),
            "block1": _block1d_init(g, dim, dim_out, causal),
            "block2": _block1d_init(g, dim_out, dim_out, causal),
            "res_conv": nn.conv1d_init(g, dim, dim_out, 1)}


def _resnet_block(p, x, mask, t_emb, causal: bool):
    h = _block1d(p["block1"], x, mask, causal)
    h = h + nn.linear(p["mlp"], F.mish(t_emb))[:, None, :]
    h = _block1d(p["block2"], h, mask, causal)
    return h + nn.conv1d(p["res_conv"], x * mask, padding=0)


def _transformer_block_init(g, dim, heads, head_dim) -> Params:
    inner = heads * head_dim
    return {
        "norm1": nn.layer_norm_init(dim, g.device),
        "to_q": nn.linear_init(g, dim, inner, bias=False),
        "to_k": nn.linear_init(g, dim, inner, bias=False),
        "to_v": nn.linear_init(g, dim, inner, bias=False),
        "to_out": nn.linear_init(g, inner, dim),
        "norm3": nn.layer_norm_init(dim, g.device),
        "ff_in": nn.linear_init(g, dim, dim * 4),
        "ff_out": nn.linear_init(g, dim * 4, dim),
    }


def _transformer_block(p, x, attn_bias, heads, head_dim):
    B, T, _ = x.shape
    h = nn.layer_norm(p["norm1"], x, eps=1e-5)
    split = lambda t: t.reshape(B, T, heads, head_dim).transpose(1, 2)
    q, k, v = (split(nn.linear(p[n], h)) for n in ("to_q", "to_k", "to_v"))
    scores = q @ k.transpose(-1, -2) / math.sqrt(head_dim)
    if attn_bias is not None:
        scores = scores + attn_bias[:, None]
    o = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(B, T, heads * head_dim)
    x = x + nn.linear(p["to_out"], o)
    h = nn.gelu(nn.linear(p["ff_in"], nn.layer_norm(p["norm3"], x, eps=1e-5)))
    return x + nn.linear(p["ff_out"], h)


def estimator_init(g: torch.Generator, cfg: EstimatorConfig) -> Params:
    chans = tuple(cfg.channels)
    time_dim = chans[0] * 4
    tblocks = lambda ch: [_transformer_block_init(g, ch, cfg.num_heads, cfg.attention_head_dim)
                          for _ in range(cfg.n_blocks)]
    p: Params = {"time_mlp": {"lin1": nn.linear_init(g, cfg.in_channels, time_dim),
                              "lin2": nn.linear_init(g, time_dim, time_dim)},
                 "down": [], "mid": [], "up": []}
    out_ch = cfg.in_channels
    for ch in chans:
        p["down"].append({"resnet": _resnet_block_init(g, out_ch, ch, time_dim, cfg.causal),
                          "transformers": tblocks(ch),
                          "downsample": nn.conv1d_init(g, ch, ch, 3)})
        out_ch = ch
    for _ in range(cfg.num_mid_blocks):
        p["mid"].append({"resnet": _resnet_block_init(g, chans[-1], chans[-1], time_dim,
                                                      cfg.causal),
                         "transformers": tblocks(chans[-1])})
    up_chans = chans[::-1] + (chans[0],)
    for i in range(len(up_chans) - 1):
        in_ch, ch = up_chans[i] * 2, up_chans[i + 1]
        # applied as a convolution on every level, as the JAX package does
        # (the deployed configs have a single level, whose kernel is 3)
        k = 3 if i == len(up_chans) - 2 else 4
        p["up"].append({"resnet": _resnet_block_init(g, in_ch, ch, time_dim, cfg.causal),
                        "transformers": tblocks(ch),
                        "upsample": nn.conv1d_init(g, ch, ch, k)})
    p["final_block"] = _block1d_init(g, up_chans[-1], up_chans[-1], cfg.causal)
    p["final_proj"] = nn.conv1d_init(g, up_chans[-1], cfg.out_channels, 1)
    return p


def _chunk_attn_bias(mask: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """(B, T) padding mask -> additive bias (B, T, T); chunk_size > 0 is the
    wenet static chunk mask with all left context."""
    T = mask.shape[1]
    valid = (mask[:, None, :] > 0)
    if chunk_size > 0:
        pos = torch.arange(T, device=mask.device)
        valid = valid & ((pos[None, :] // chunk_size) <= (pos[:, None] // chunk_size))[None]
    return torch.where(valid, 0.0, -1e10).to(mask.dtype)


def estimator_apply(p: Params, cfg: EstimatorConfig, x, mask, mu, t, spks, cond):
    """x / mu / cond (B, T, 80), mask (B, T), t (B,), spks (B, spk) ->
    velocity (B, T, 80)."""
    t_emb = nn.linear(p["time_mlp"]["lin1"], _sinusoidal_t_emb(t, cfg.in_channels))
    t_emb = nn.linear(p["time_mlp"]["lin2"], F.silu(t_emb))
    B, T, _ = x.shape
    h = torch.cat([x, mu, spks[:, None, :].expand(B, T, spks.shape[-1]), cond], -1)
    m = mask[:, :, None]
    attn_bias = _chunk_attn_bias(mask, cfg.static_chunk_size)

    def stage(blk, h):
        h = _resnet_block(blk["resnet"], h, m, t_emb, cfg.causal)
        for tb in blk["transformers"]:
            h = _transformer_block(tb, h, attn_bias, cfg.num_heads, cfg.attention_head_dim)
        return h

    def resample(conv, h):  # the deployed single level: a stride-1 conv
        return nn.conv1d(conv, h * m, padding=(2, 0) if cfg.causal else 1)

    hiddens = []
    for blk in p["down"]:
        h = stage(blk, h)
        hiddens.append(h)
        h = resample(blk["downsample"], h)
    for blk in p["mid"]:
        h = stage(blk, h)
    for blk in p["up"]:
        skip = hiddens.pop()
        h = stage(blk, torch.cat([h[:, :skip.shape[1]], skip], -1))
        h = resample(blk["upsample"], h)
    h = _block1d(p["final_block"], h, m, cfg.causal)
    return nn.conv1d(p["final_proj"], h * m, padding=0) * m


# ---------------------------------------------------------------------------
# CFM: Euler solver with classifier-free guidance
# ---------------------------------------------------------------------------


def cfm_solve(p_est: Params, est_cfg: EstimatorConfig, cfm: CFMConfig, z, mu, mask, spks,
              cond, n_timesteps: int = 10):
    """Fixed-step Euler ODE on the cosine t-schedule with CFG
    (flow_matching.py:71-122)."""
    ts = 1 - torch.cos(torch.linspace(0.0, 1.0, n_timesteps + 1, device=z.device) * 0.5 * math.pi)
    B = mu.shape[0]
    mu2 = torch.cat([mu, torch.zeros_like(mu)], 0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], 0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], 0)
    mask2 = torch.cat([mask, mask], 0)
    rate = cfm.inference_cfg_rate
    x = z
    for i in range(n_timesteps):
        v2 = estimator_apply(p_est, est_cfg, torch.cat([x, x], 0), mask2, mu2,
                             ts[i].expand(2 * B), spks2, cond2)
        v = (1.0 + rate) * v2[:B] - rate * v2[B:]
        x = x + (ts[i + 1] - ts[i]) * v
    return x


# the CFG training drop: a row's conditions are dropped with this probability
TRAINING_CFG_RATE = 0.2


def _keep_mask(B: int, keep, generator, device) -> torch.Tensor:
    """The rows whose conditions survive the CFG training drop (a uniform
    draw > TRAINING_CFG_RATE), as 0 / 1."""
    if keep is None:
        keep = torch.rand(B, generator=generator, device=device) > TRAINING_CFG_RATE
    return keep.to(device)


def cfm_loss(p_est: Params, est_cfg: EstimatorConfig, cfm: CFMConfig, x1, mask, mu, spks,
             cond, generator: Optional[torch.Generator] = None, t=None, z=None, keep=None):
    """The CFM training loss (flow_matching.py:145-185): x1 / mu / cond (B, T,
    80), mask (B, T), spks (B, D). Draws from `generator` on x1's device,
    in this order, unless passed in: `t` (B, 1, 1) uniform (before the
    t-schedule), `z` like x1 normal, `keep` (B,) bool, the rows whose
    conditions survive the CFG drop. Returns (loss, y), y the noisy input
    at t."""
    B, dev = x1.shape[0], x1.device
    if t is None:
        t = torch.rand(B, 1, 1, generator=generator, device=dev)
    t = 1 - torch.cos(t.reshape(B, 1, 1).to(x1.dtype) * 0.5 * math.pi)
    if z is None:
        z = torch.randn(x1.shape, generator=generator, device=dev)
    y = (1 - (1 - cfm.sigma_min) * t) * z + t * x1
    u = x1 - (1 - cfm.sigma_min) * z
    k = _keep_mask(B, keep, generator, dev).to(mu.dtype)
    mu, spks, cond = mu * k[:, None, None], spks * k[:, None], cond * k[:, None, None]
    pred = estimator_apply(p_est, est_cfg, y, mask, mu, t[:, 0, 0], spks, cond)
    m = mask[:, :, None]
    return (((pred - u) * m) ** 2).sum() / (m.sum() * u.shape[-1]), y


# ---------------------------------------------------------------------------
# SFM head
# ---------------------------------------------------------------------------


def sfm_head_init(g: torch.Generator, d_hidden: int, mel_channels: int) -> Params:
    return {"conv1": nn.conv1d_init(g, d_hidden, d_hidden, 3),
            "ln1": nn.layer_norm_init(d_hidden, g.device),
            "conv2": nn.conv1d_init(g, d_hidden, d_hidden, 3),
            "ln2": nn.layer_norm_init(d_hidden, g.device),
            "proj": nn.linear_init(g, d_hidden, mel_channels + 2)}


def sfm_head_apply(p: Params, h: torch.Tensor, mel_channels: int):
    """h (B, T, C) -> (x_h (B, T, mel), t_h (B, 1), log_sigma_sq (B, 1))."""
    x = F.relu(nn.layer_norm(p["ln1"], nn.conv1d(p["conv1"], h, padding=1), eps=1e-5))
    x = F.relu(nn.layer_norm(p["ln2"], nn.conv1d(p["conv2"], x, padding=1), eps=1e-5))
    x = nn.linear(p["proj"], x)
    x_h = x[..., :mel_channels]
    t_h = torch.sigmoid(x[..., mel_channels:mel_channels + 1]).mean(1)
    return x_h, t_h, x[..., mel_channels + 1:].mean(1)


# ---------------------------------------------------------------------------
# Positional noise
# ---------------------------------------------------------------------------


class NoiseTable:
    """Gaussian CFM noise over absolute mel frames, (1, frames, channels),
    drawn from a seeded generator in blocks of `block` frames on first
    use, so frame t has one value whatever size is asked for first."""

    def __init__(self, seed: int, channels: int, device=None, block: int = 1024):
        self.g = torch.Generator().manual_seed(seed)
        self.channels, self.device, self.block = channels, device, block
        self.table = torch.zeros(1, 0, channels, device=device)

    def __call__(self, n_frames: int) -> torch.Tensor:
        while self.table.shape[1] < n_frames:
            new = torch.randn(1, self.block, self.channels, generator=self.g)
            self.table = torch.cat([self.table, new.to(self.device)], 1)
        return self.table


# ---------------------------------------------------------------------------
# Flow wrapper (CausalMaskedDiffWithXvec)
# ---------------------------------------------------------------------------


def init_params(g: torch.Generator, cfg: FlowConfig) -> Params:
    p = {
        "input_embedding": 0.02 * torch.randn(cfg.vocab_size, cfg.input_size, generator=g,
                                              device=g.device),
        "spk_affine": nn.linear_init(g, cfg.spk_embed_dim, cfg.output_size),
        "encoder": conformer.init_params(g, cfg.encoder),
        "encoder_proj": nn.linear_init(g, cfg.encoder.output_size, cfg.output_size),
        "estimator": estimator_init(g, cfg.estimator),
    }
    if cfg.sfm:
        p["sfm_head"] = sfm_head_init(g, cfg.encoder.output_size, cfg.output_size)
    return p


def encode_tokens(p: Params, cfg: FlowConfig, tokens, token_mask):
    """tokens (B, Tt) -> encoder hidden (B, Tt * ratio, enc_dim)."""
    emb = p["input_embedding"][tokens.clamp_min(0)] * token_mask[:, :, None]
    return conformer.apply(p["encoder"], cfg.encoder, emb, mask=token_mask)


def _spks(p, spk_embedding):
    """The x-vector, l2-normalised, through the speaker affine."""
    emb = spk_embedding * torch.rsqrt((spk_embedding ** 2).sum(-1, keepdim=True) + 1e-12)
    return nn.linear(p["spk_affine"], emb)


def _condition(p, cfg: FlowConfig, tokens, token_mask, prompt_feat, spk_embedding):
    """(spks, mu, mel mask, conds) of a token buffer."""
    spks = _spks(p, spk_embedding)
    mu = nn.linear(p["encoder_proj"], encode_tokens(p, cfg, tokens, token_mask))
    mel_mask = torch.repeat_interleave(token_mask, cfg.token_mel_ratio, 1).to(mu.dtype)
    conds = torch.zeros_like(mu)
    conds[:, :prompt_feat.shape[1]] = prompt_feat.to(mu.dtype)
    return spks, mu, mel_mask, conds


def inference(p: Params, cfg: FlowConfig, tokens, token_mask, prompt_feat,
              prompt_feat_len: int, spk_embedding, noise: torch.Tensor,
              n_timesteps: Optional[int] = None):
    """Zero-shot mel generation (flow.py:194-241). tokens (B, Tt) prompt +
    target speech tokens; token_mask (B, Tt); prompt_feat (B, Tp, 80);
    spk_embedding (B, 192); noise (B, >= Tt * ratio, 80) the CFM noise
    over absolute frames. Returns the generated mel (B, Tt * ratio - Tp, 80)."""
    spks, mu, mel_mask, conds = _condition(p, cfg, tokens, token_mask, prompt_feat,
                                           spk_embedding)
    z = noise[:, :mu.shape[1]].to(mu)
    feat = cfm_solve(p["estimator"], cfg.estimator, cfg.cfm, z, mu, mel_mask, spks, conds,
                     n_timesteps=n_timesteps or cfg.n_timesteps)
    return feat[:, prompt_feat_len:]


def window_frames(prompt_len: int, gen_start: int, n_frames: int, ratio: int) -> torch.Tensor:
    """Absolute frame of each window frame: the prompt frames keep their
    place, the rest shift by ratio * gen_start (flow.py:534-538)."""
    pos = torch.arange(n_frames)
    return torch.where(pos < ratio * prompt_len, pos, pos + ratio * gen_start)


def inference_window(p: Params, cfg: FlowConfig, tokens, token_mask, prompt_feat,
                     prompt_len: int, gen_start: int, spk_embedding, noise: torch.Tensor,
                     n_timesteps: Optional[int] = None):
    """One bounded-window streaming hop. tokens (B, Wt) = [prompt tokens |
    window of generated tokens | right pad], token_mask marking the valid
    entries; gen_start the index in the generated stream of the first
    window token after the prompt; noise (B, frames, 80) over absolute
    frames (at least ratio * (Wt + gen_start)). Returns the mel of the whole
    window (B, Wt * ratio, 80); the caller slices out the new frames."""
    spks, mu, mel_mask, conds = _condition(p, cfg, tokens, token_mask, prompt_feat,
                                           spk_embedding)
    idx = window_frames(prompt_len, gen_start, mu.shape[1], cfg.token_mel_ratio)
    z = noise[:, idx.to(noise.device)].to(mu)
    return cfm_solve(p["estimator"], cfg.estimator, cfg.cfm, z, mu, mel_mask, spks, conds,
                     n_timesteps=n_timesteps or cfg.n_timesteps)


# ---------------------------------------------------------------------------
# SFM fast decode
# ---------------------------------------------------------------------------


def _sfm_solve(p: Params, cfg: FlowConfig, tokens, token_mask, spk_embedding, noise_at,
               n_timesteps: Optional[int]):
    """The SFM ODE (model/flow/flow_matching.py:24-90): the head's coarse
    prediction x_h, its time t_h and spread sigma_h, scaled by
    sfm_strength (Eq. 22), set the start x = sqrt(noise^2) z + x_h_bar at
    t_h_bar; Euler steps to 1 without guidance, with zero conds (the prompt
    rides as concatenated tokens). noise_at(n_frames) -> z (B, n_frames,
    mel). Returns the mel of the whole buffer (B, Tt * ratio, mel)."""
    n_timesteps = n_timesteps or cfg.n_timesteps
    alpha, sigma_min = cfg.sfm_strength, cfg.cfm.sigma_min
    spks = _spks(p, spk_embedding)
    h = encode_tokens(p, cfg, tokens, token_mask)
    mu = nn.linear(p["encoder_proj"], h)
    x_h, t_h, log_sig = sfm_head_apply(p["sfm_head"], h, cfg.output_size)
    sigma_h = torch.exp(0.5 * log_sig)
    delta = torch.clamp_min(alpha * ((1 - sigma_min) * t_h + sigma_h), 1.0)  # (B, 1)
    x_h_bar = (alpha / delta)[:, :, None] * x_h
    t_h_bar = (alpha / delta) * t_h
    sig_sq_bar = (alpha ** 2 / delta ** 2) * sigma_h ** 2
    z = noise_at(mu.shape[1]).to(mu)
    noise_sq = torch.clamp_min((1 - (1 - sigma_min) * t_h_bar) ** 2 - sig_sq_bar, 0.0)
    x = torch.sqrt(noise_sq)[:, :, None] * z + x_h_bar
    mel_mask = torch.repeat_interleave(token_mask, cfg.token_mel_ratio, 1).to(mu.dtype)
    conds = torch.zeros_like(mu)
    t0 = t_h_bar[:, 0]
    dt = (1.0 - t0) / n_timesteps
    for i in range(n_timesteps):
        v = estimator_apply(p["estimator"], cfg.estimator, x, mel_mask, mu,
                            t0 + (1.0 - t0) * i / n_timesteps, spks, conds)
        x = x + dt[:, None, None] * v
    return x


def sfm_inference(p: Params, cfg: FlowConfig, tokens, token_mask, spk_embedding,
                  noise: torch.Tensor, n_timesteps: Optional[int] = None):
    """SFM fast decode of a token buffer (prompt + target tokens, already
    concatenated): noise (B, >= Tt * ratio, mel) over absolute frames.
    Returns the mel (B, Tt * ratio, mel); the caller slices off the
    prompt's frames."""
    return _sfm_solve(p, cfg, tokens, token_mask, spk_embedding, lambda t: noise[:, :t],
                      n_timesteps)


def sfm_inference_window(p: Params, cfg: FlowConfig, tokens, token_mask, prompt_len: int,
                         gen_start: int, spk_embedding, noise: torch.Tensor,
                         n_timesteps: Optional[int] = None):
    """The bounded-window streaming hop on the SFM path: the window
    contract of ``inference_window`` (noise over absolute frames, indexed
    by ``window_frames``), no prompt mel. Returns the mel of the whole
    window (B, Wt * ratio, mel)."""
    def noise_at(n_frames):
        idx = window_frames(prompt_len, gen_start, n_frames, cfg.token_mel_ratio)
        return noise[:, idx.to(noise.device)]

    return _sfm_solve(p, cfg, tokens, token_mask, spk_embedding, noise_at, n_timesteps)


def sfm_loss(p: Params, cfg: FlowConfig, tokens, token_mask, x1, feat_mask, spk_embedding,
             generator: Optional[torch.Generator] = None, x0=None, t_u=None, keep=None):
    """The four-term SFM training loss (model/flow/flow.py:64-121):
    L_coarse + L_t + L_sigma + (L_cfm + L_mu). tokens / token_mask (B, Tt),
    x1 the target mel (B, Tt x ratio, 80), feat_mask (B, Tt x ratio),
    spk_embedding (B, 192). The targets of the head (t_true, sigma_true)
    and the piecewise path's start are taken without gradient, as the
    reference's stop-gradients. Draws from `generator` on x1's device, in
    this order, unless passed in: `x0` like x1 normal, `t_u` (B, 1, 1)
    uniform, `keep` (B,) bool (the CFG drop). Returns (total, the five
    terms by name)."""
    sigma_min = cfg.cfm.sigma_min
    B, dev = x1.shape[0], x1.device
    spks = _spks(p, spk_embedding)
    h = encode_tokens(p, cfg, tokens, token_mask)
    x_g = nn.linear(p["encoder_proj"], h)
    x_h, t_h, log_sig = sfm_head_apply(p["sfm_head"], h, cfg.output_size)

    m = feat_mask[:, :, None]
    loss_coarse = mesh_lib.global_mean((x_g * m - x1 * m).abs())

    # orthogonal projection targets (flow.py:87-98)
    x_h_sg = x_h.detach()
    dot = (x_h_sg * x1).sum((1, 2))
    t_true = (dot / ((x1 * x1).sum((1, 2)) + 1e-8)).clamp(0.0, 1.0)[:, None]
    sig_sq_true = ((x_h_sg - t_true[:, :, None] * x1) ** 2).mean((1, 2)).clamp_min(1e-7)[:, None]
    loss_t = mesh_lib.global_mean((t_h - t_true) ** 2)
    loss_sigma = mesh_lib.global_mean((log_sig - torch.log(sig_sq_true)) ** 2)

    # the piecewise CFM (flow_matching.py:176-227)
    delta = ((1 - sigma_min) * t_true + torch.sqrt(sig_sq_true)).clamp_min(1.0)
    x_h_bar = (1.0 / delta)[:, :, None] * x_h
    t_h_bar = ((1.0 / delta) * t_true)[:, :, None]
    sig_sq_bar = (1.0 / delta ** 2) * sig_sq_true
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=dev)
    noise_sq = ((1 - (1 - sigma_min) * t_h_bar[:, :, 0]) ** 2 - sig_sq_bar).clamp_min(0.0)
    x_t_h = torch.sqrt(noise_sq)[:, :, None] * x0 + x_h_bar
    if t_u is None:
        t_u = torch.rand(B, 1, 1, generator=generator, device=dev)
    t_u = t_u.reshape(B, 1, 1).to(x1.dtype) * (1 - t_h_bar) + t_h_bar
    target = x1 + sigma_min * x0
    x_t = (1 - t_u) * x_t_h.detach() + t_u * target
    u_t = (1.0 / (1.0 - t_true[:, :, None] + 1e-8)) * (target - x_t_h.detach())
    t_s = (1 - t_h_bar) * t_u + t_h_bar

    mu, cond = x_g, torch.zeros_like(x_g)
    k = _keep_mask(B, keep, generator, dev).to(mu.dtype)
    mu, spks = mu * k[:, None, None], spks * k[:, None]
    pred = estimator_apply(p["estimator"], cfg.estimator, x_t, feat_mask, mu, t_s[:, 0, 0],
                           spks, cond)
    loss_cfm = (((pred - u_t) * m) ** 2).sum() / (mesh_lib.global_sum(m.sum()) * u_t.shape[-1])
    loss_mu = mesh_lib.global_mean((x_h - t_true[:, :, None] * x1) ** 2)
    total = loss_coarse + loss_t + loss_sigma + loss_cfm + loss_mu
    return total, {"loss_coarse": loss_coarse, "loss_t": loss_t, "loss_sigma": loss_sigma,
                   "loss_cfm": loss_cfm, "loss_mu": loss_mu}

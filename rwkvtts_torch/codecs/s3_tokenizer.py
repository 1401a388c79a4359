"""S3 speech tokenizer, CosyVoice2's ``speech_tokenizer_v2.onnx``
(counterpart of rwkvtts_tpu/codecs/s3_tokenizer.py; the published
S3TokenizerV2 architecture, "speech_tokenizer_v2_25hz"):

  128-bin whisper log-mel (16 kHz, n_fft 400, hop 160, 100 Hz)
  -> conv k3 s2 + gelu -> conv k3 s2 + gelu        (100 Hz -> 25 Hz)
  -> + sinusoidal positions -> pre-LN transformer blocks
  -> FSQ head: Linear(d -> 8), 3 levels a dim      (vocab 3^8 = 6561)

The tokens are FSQ roundings at the half, so the whole model runs in
float32 with TF32 off (``nn.f32``): a product at TF32 would flip tokens.
Weights load from the torch ``s3tokenizer`` checkpoint layout
(``s3_from_torch_state_dict``) or from the ONNX file's initializers
(``s3_from_onnx``, through the port's protobuf reader; ``probe_onnx``
lists an export's initializer names). Channels-last (B, T, C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from rwkvtts_torch.codecs import nn
from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.codecs.quantizers import fsq_codes_to_indices, fsq_quantize
from rwkvtts_torch.codecs.xy_tokenizer import _tf_layer_init, _tf_stack, sinusoids, whisper_log_mel
from rwkvtts_torch.utils import onnx_import

Params = nn.Params

S3_LEVELS = (3, 3, 3, 3, 3, 3, 3, 3)  # 3^8 = 6561


@dataclasses.dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    d_model: int = 1280
    layers: int = 12
    heads: int = 20
    ffn_dim: int = 5120
    fsq_dim: int = 8
    max_positions: int = 750  # 30 s at 25 Hz
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160

    @property
    def vocab_size(self) -> int:
        n = 1
        for lv in S3_LEVELS:
            n *= lv
        return n  # 6561


def init_params(g: torch.Generator, cfg: S3TokenizerConfig) -> Params:
    """f32 parameters drawn from `g` on its device (the JAX package's tree
    and distributions; other values)."""
    d = cfg.d_model
    return {
        "conv1": nn.conv1d_init(g, cfg.n_mels, d, 3),
        "conv2": nn.conv1d_init(g, d, d, 3),
        "layers": [_tf_layer_init(g, d, cfg.ffn_dim) for _ in range(cfg.layers)],
        "ln": nn.layer_norm_init(d, g.device),
        "fsq_proj": nn.linear_init(g, d, cfg.fsq_dim),
    }


@torch.inference_mode()
def encode_mel(p: Params, cfg: S3TokenizerConfig, mel: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """mel (B, T100, n_mels) -> (tokens (B, T25) int32, token mask (B, T25));
    `mask` (B, T100) marks valid mel frames, and masked tokens are 0."""
    with nn.f32():
        h = nn.gelu(nn.conv1d(p["conv1"], mel.float(), stride=2, padding=1))
        h = nn.gelu(nn.conv1d(p["conv2"], h, stride=2, padding=1))
        T = h.shape[1]
        h = h + torch.from_numpy(sinusoids(T, cfg.d_model)).to(h)
        sub = mask[:, ::4][:, :T] if mask is not None else None
        h = _tf_stack(p["layers"], h, cfg.heads, sub)
        h = nn.layer_norm(p["ln"], h, eps=1e-5)
        z = nn.linear(p["fsq_proj"], h)  # (B, T25, 8)
    tokens = fsq_codes_to_indices(fsq_quantize(z, S3_LEVELS), S3_LEVELS)
    if sub is not None:
        return torch.where(sub > 0, tokens, 0), sub
    return tokens, torch.ones(tokens.shape, device=tokens.device)


def log_mel(cfg: S3TokenizerConfig, wav: torch.Tensor) -> torch.Tensor:
    """Whisper's 128-bin log-mel. wav (B, T) at 16 kHz -> (B, T // hop, 128)."""
    with nn.f32():
        return whisper_log_mel(wav.float(), sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                               hop=cfg.hop, n_mels=cfg.n_mels)


def tokenize(p: Params, cfg: S3TokenizerConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, T) at 16 kHz -> speech tokens (B, T25) at 25 Hz."""
    tokens, _ = encode_mel(p, cfg, log_mel(cfg, wav))
    return tokens


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------


def s3_from_torch_state_dict(sd, cfg: S3TokenizerConfig, device=None) -> Params:
    """The public ``s3tokenizer`` torch checkpoint layout -> the port's
    tree (f32 tensors on `device`). Layer names follow whisper's
    ResidualAttentionBlock (attn.query / key / value / out, attn_ln, mlp.0 /
    mlp.2, mlp_ln), under an ``encoder.`` prefix or none; the FSQ
    projection under ``quantizer.``."""
    pref = "encoder." if "encoder.conv1.weight" in sd else ""
    layers = []
    for i in range(cfg.layers):
        b = f"{pref}blocks.{i}"
        layers.append({
            "attn_ln": ti.layer_norm_p(sd, f"{b}.attn_ln"),
            "q": ti.linear_p(sd, f"{b}.attn.query"),
            "k": ti.linear_p(sd, f"{b}.attn.key"),
            "v": ti.linear_p(sd, f"{b}.attn.value"),
            "out": ti.linear_p(sd, f"{b}.attn.out"),
            "final_ln": ti.layer_norm_p(sd, f"{b}.mlp_ln"),
            "fc1": ti.linear_p(sd, f"{b}.mlp.0"),
            "fc2": ti.linear_p(sd, f"{b}.mlp.2"),
        })
    for cand in ("quantizer._codebook.project_down", "quantizer.project_down", f"{pref}proj"):
        if f"{cand}.weight" in sd:
            fsq = ti.linear_p(sd, cand)
            break
    else:
        raise KeyError("FSQ projection not found in state_dict")
    return ti.tensors({
        "conv1": ti.conv1d_p(sd, f"{pref}conv1"),
        "conv2": ti.conv1d_p(sd, f"{pref}conv2"),
        "layers": layers,
        "ln": ti.layer_norm_p(sd, f"{pref}ln_post"),
        "fsq_proj": fsq,
    }, device)


def probe_onnx(path: str):
    """(name, shape) of every initializer of an ONNX export, sorted: the
    aid for mapping an export with other names."""
    ws = onnx_import.load_onnx_initializers(path)
    return sorted((k, tuple(v.shape)) for k, v in ws.items())


def s3_from_onnx(path: str, cfg: S3TokenizerConfig, device=None) -> Params:
    """speech_tokenizer_v2.onnx -> the port's tree. ONNX exports keep the
    torch module names in their initializer names, so the torch-layout
    mapping applies; an unmapped name raises with the first initializers
    listed."""
    sd = onnx_import.load_onnx_initializers(path)
    try:
        return s3_from_torch_state_dict(sd, cfg, device)
    except KeyError as e:
        names = "\n".join(f"  {k}: {tuple(v.shape)}" for k, v in sorted(sd.items())[:80])
        raise KeyError(f"s3_from_onnx: unmapped initializer names ({e}); "
                       f"first initializers:\n{names}") from e

"""CAM++ speaker embedding (x-vector), CosyVoice's ``campplus.onnx``
(counterpart of rwkvtts_tpu/codecs/campplus.py; the published CAM++ of
Alibaba's speakerlab D-TDNN, "speech_campplus_sv_zh-cn_16k-common"):

  FCM 2-D front end (res blocks, freq / 8)         -> (B, T, 320)
  TDNN k5 s2                                       -> (B, T/2, 128)
  3 CAM dense-TDNN blocks (12 / 24 / 16 layers, growth 32, dilation 1 / 2 / 2,
     context-aware masking), each + a transit / 2
  stats pooling (mean || std) -> dense             -> (B, 192)

Batch norm runs in inference mode from the running statistics. The 2-D
front end is NCHW over (channels, freq, time) with PyTorch's conv2d
weights (out, in, kh, kw); the 1-D body is channels-last (B, T, C) through
codecs/nn.py. The kaldi fbank front end (``kaldi_fbank``) follows
torchaudio.compliance.kaldi.fbank at dither 0, as the JAX package does.
Everything runs in float32 with TF32 off (``nn.f32``).

Weights import from a speakerlab torch state dict (``campplus_from_torch``)
or an ONNX export whose initializer names keep the module paths
(``load_campplus_onnx``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rwkvtts_torch.codecs import dsp, nn
from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.utils import onnx_import

Params = nn.Params


@dataclasses.dataclass(frozen=True)
class CampplusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    m_channels: int = 32
    init_channels: int = 128
    growth_rate: int = 32
    bn_size: int = 4
    block_layers: Tuple[int, ...] = (12, 24, 16)
    block_dilations: Tuple[int, ...] = (1, 2, 2)
    seg_len: int = 100

    @property
    def fcm_out(self) -> int:
        return self.m_channels * (self.feat_dim // 8)  # 320


# ---------------------------------------------------------------------------
# FCM 2-D front end (NCHW: channels, freq, time)
# ---------------------------------------------------------------------------


def _bn2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Inference batch norm over the channel axis of (B, C, H, W)."""
    return nn.batch_norm(p, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _conv2d(p: Params, x: torch.Tensor, stride=(1, 1), padding=(1, 1)) -> torch.Tensor:
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


def _conv2d_init(g: torch.Generator, cin: int, cout: int, k: int) -> Params:
    return {"w": torch.randn(cout, cin, k, k, generator=g, device=g.device)
            / math.sqrt(k * k * cin)}


def _res_block_init(g: torch.Generator, cin: int, cout: int, stride: int) -> Params:
    dev = g.device
    p = {"conv1": _conv2d_init(g, cin, cout, 3), "bn1": nn.batch_norm_init(cout, dev),
         "conv2": _conv2d_init(g, cout, cout, 3), "bn2": nn.batch_norm_init(cout, dev)}
    if stride != 1 or cin != cout:
        p["shortcut"] = {"conv": {"w": 0.1 * torch.randn(cout, cin, 1, 1, generator=g,
                                                         device=dev)},
                         "bn": nn.batch_norm_init(cout, dev)}
    return p


def _res_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_bn2d(p["bn1"], _conv2d(p["conv1"], x, stride=(stride, 1))))
    h = _bn2d(p["bn2"], _conv2d(p["conv2"], h))
    if "shortcut" in p:
        s = _bn2d(p["shortcut"]["bn"],
                  _conv2d(p["shortcut"]["conv"], x, stride=(stride, 1), padding=(0, 0)))
    else:
        s = x
    return F.relu(h + s)


def fcm_init(g: torch.Generator, cfg: CampplusConfig) -> Params:
    m, dev = cfg.m_channels, g.device
    return {
        "conv1": _conv2d_init(g, 1, m, 3), "bn1": nn.batch_norm_init(m, dev),
        "layer1": [_res_block_init(g, m, m, 2), _res_block_init(g, m, m, 1)],
        "layer2": [_res_block_init(g, m, m, 2), _res_block_init(g, m, m, 1)],
        "conv2": _conv2d_init(g, m, m, 3), "bn2": nn.batch_norm_init(m, dev),
    }


def fcm_apply(p: Params, cfg: CampplusConfig, feat: torch.Tensor) -> torch.Tensor:
    """feat (B, T, F) -> (B, T, fcm_out); the 2-D grid is (freq, time)."""
    x = feat.transpose(1, 2)[:, None]  # (B, 1, F, T)
    x = F.relu(_bn2d(p["bn1"], _conv2d(p["conv1"], x)))
    for blk, s in zip(p["layer1"], (2, 1)):
        x = _res_block(blk, x, s)
    for blk, s in zip(p["layer2"], (2, 1)):
        x = _res_block(blk, x, s)
    x = F.relu(_bn2d(p["bn2"], _conv2d(p["conv2"], x, stride=(2, 1))))
    B, C, Fr, T = x.shape
    return x.reshape(B, C * Fr, T).transpose(1, 2)  # channel-major stacking


# ---------------------------------------------------------------------------
# D-TDNN body (channels-last)
# ---------------------------------------------------------------------------


def _bn_relu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.relu(nn.batch_norm(p, x))


def _cam_layer_init(g: torch.Generator, bn_ch: int, out_ch: int, k: int,
                    reduction: int = 2) -> Params:
    return {"local": nn.conv1d_init(g, bn_ch, out_ch, k, bias=False),
            "lin1": nn.conv1d_init(g, bn_ch, bn_ch // reduction, 1),
            "lin2": nn.conv1d_init(g, bn_ch // reduction, out_ch, 1)}


def _seg_pool(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """Segment means repeated back over their frames (the CAM layer's
    ceil-mode average pooling): the last, partial segment is divided by
    its own frame count. x (B, T, C) -> (B, T, C)."""
    B, T, C = x.shape
    n_seg = -(-T // seg_len)
    seg = F.pad(x, (0, 0, 0, n_seg * seg_len - T)).reshape(B, n_seg, seg_len, C)
    counts = torch.clamp_max(T - torch.arange(n_seg, device=x.device) * seg_len, seg_len)
    seg = seg.sum(2) / counts.to(x.dtype)[None, :, None]
    return torch.repeat_interleave(seg, seg_len, 1)[:, :T]


def _cam_layer(p: Params, x: torch.Tensor, k: int, dilation: int, seg_len: int) -> torch.Tensor:
    """x (B, T, bn_ch) -> (B, T, out)."""
    y = nn.conv1d(p["local"], x, dilation=dilation, padding=(k - 1) // 2 * dilation)
    context = x.mean(1, keepdim=True) + _seg_pool(x, seg_len)
    context = F.relu(nn.conv1d(p["lin1"], context, padding=0))
    return y * torch.sigmoid(nn.conv1d(p["lin2"], context, padding=0))


def _dense_layer_init(g: torch.Generator, cin: int, bn_ch: int, out_ch: int, k: int) -> Params:
    dev = g.device
    return {"nl1": nn.batch_norm_init(cin, dev),
            "lin1": nn.conv1d_init(g, cin, bn_ch, 1, bias=False),
            "nl2": nn.batch_norm_init(bn_ch, dev),
            "cam": _cam_layer_init(g, bn_ch, out_ch, k)}


def _dense_layer(p: Params, x: torch.Tensor, k: int, dilation: int, seg_len: int
                 ) -> torch.Tensor:
    h = nn.conv1d(p["lin1"], _bn_relu(p["nl1"], x), padding=0)
    return _cam_layer(p["cam"], _bn_relu(p["nl2"], h), k, dilation, seg_len)


def init_params(g: torch.Generator, cfg: CampplusConfig) -> Params:
    """f32 parameters drawn from `g` on its device (the JAX package's tree,
    shapes and distributions; other values)."""
    dev = g.device
    p: Params = {"fcm": fcm_init(g, cfg)}
    p["tdnn"] = {"conv": nn.conv1d_init(g, cfg.fcm_out, cfg.init_channels, 5),
                 "bn": nn.batch_norm_init(cfg.init_channels, dev)}
    ch, bn_ch = cfg.init_channels, cfg.bn_size * cfg.growth_rate
    p["blocks"], p["transits"] = [], []
    for n_layers in cfg.block_layers:
        p["blocks"].append([_dense_layer_init(g, ch + j * cfg.growth_rate, bn_ch,
                                              cfg.growth_rate, 3) for j in range(n_layers)])
        ch += n_layers * cfg.growth_rate
        p["transits"].append({"nl": nn.batch_norm_init(ch, dev),
                              "lin": nn.conv1d_init(g, ch, ch // 2, 1, bias=False)})
        ch //= 2
    p["out_nl"] = nn.batch_norm_init(ch, dev)
    p["dense"] = {"lin": nn.linear_init(g, ch * 2, cfg.embedding_size, bias=False),
                  "bn": nn.batch_norm_init(cfg.embedding_size, dev)}
    return p


@torch.inference_mode()
def apply(p: Params, cfg: CampplusConfig, feat: torch.Tensor) -> torch.Tensor:
    """feat (B, T, feat_dim) mean-normalised kaldi fbank -> x-vector
    (B, embedding_size)."""
    with nn.f32():
        x = fcm_apply(p["fcm"], cfg, feat.float())
        x = _bn_relu(p["tdnn"]["bn"], nn.conv1d(p["tdnn"]["conv"], x, stride=2, padding=4))
        for layers, transit, dil in zip(p["blocks"], p["transits"], cfg.block_dilations):
            for lyr in layers:
                x = torch.cat([x, _dense_layer(lyr, x, 3, dil, cfg.seg_len)], -1)
            x = nn.conv1d(transit["lin"], _bn_relu(transit["nl"], x), padding=0)
        x = _bn_relu(p["out_nl"], x)
        std = torch.sqrt(torch.clamp_min(x.var(1, unbiased=False), 1e-8))
        stats = torch.cat([x.mean(1), std], -1)
        return nn.batch_norm(p["dense"]["bn"], nn.linear(p["dense"]["lin"], stats))


# ---------------------------------------------------------------------------
# Kaldi fbank front end
# ---------------------------------------------------------------------------


def kaldi_fbank(wav: torch.Tensor, sample_rate: int = 16000, num_mel_bins: int = 80,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0) -> torch.Tensor:
    """torchaudio.compliance.kaldi.fbank at dither 0: int16 scaling
    (x 32768), snip_edges framing, DC removal, pre-emphasis 0.97, the povey
    window, the power of a real FFT at the next power of two (512), HTK
    mel bins without normalisation, ln(max(mel, 1e-10)).
    wav (B, T) in [-1, 1] -> (B, frames, num_mel_bins)."""
    win = int(sample_rate * frame_length_ms / 1000)  # 400
    hop = int(sample_rate * frame_shift_ms / 1000)  # 160
    n_fft = 1 << (win - 1).bit_length()  # 512
    with nn.f32():
        wav = wav.float() * 32768.0
        if wav.shape[1] < win:
            return wav.new_zeros(wav.shape[0], 0, num_mel_bins)
        frames = wav.unfold(-1, win, hop)  # (B, F, win), snip_edges
        frames = frames - frames.mean(-1, keepdim=True)
        frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], -1)
        n = torch.arange(win, device=wav.device, dtype=torch.float32)
        frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * n / (win - 1))) ** 0.85
        power = torch.fft.rfft(frames, n=n_fft).abs() ** 2
        fb = dsp.mel_filterbank(sample_rate, n_fft, num_mel_bins, 20.0, None,
                                norm="none", mel_scale="htk")
        return torch.log(torch.clamp_min(power @ torch.from_numpy(fb).to(power), 1e-10))


def embed_wav(p: Params, cfg: CampplusConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, T) at 16 kHz -> x-vector (B, embedding_size); the fbank is
    mean-normalised over each utterance (the reference frontend's)."""
    feat = kaldi_fbank(wav)
    return apply(p, cfg, feat - feat.mean(1, keepdim=True))


# ---------------------------------------------------------------------------
# Weight import
# ---------------------------------------------------------------------------


def campplus_from_torch(sd, cfg: CampplusConfig, device=None) -> Params:
    """A speakerlab CAMPPlus state dict -> the port's tree (f32 tensors on
    `device`). Convolution weights keep PyTorch's layout; the dense layer,
    a 1x1 convolution or a linear, becomes a linear (in, out)."""
    def conv2d_p(b):
        return ti.conv1d_p(sd, b)  # (out, in, kh, kw) as stored, bias if present

    def res_p(b):
        p = {"conv1": conv2d_p(f"{b}.conv1"), "bn1": ti.batch_norm_p(sd, f"{b}.bn1"),
             "conv2": conv2d_p(f"{b}.conv2"), "bn2": ti.batch_norm_p(sd, f"{b}.bn2")}
        if f"{b}.shortcut.0.weight" in sd:
            p["shortcut"] = {"conv": conv2d_p(f"{b}.shortcut.0"),
                             "bn": ti.batch_norm_p(sd, f"{b}.shortcut.1")}
        return p

    def nl_p(b):  # get_nonlinear('batchnorm-relu'): a .batchnorm submodule
        return ti.batch_norm_p(sd, f"{b}.batchnorm")

    fcm = {"conv1": conv2d_p("head.conv1"), "bn1": ti.batch_norm_p(sd, "head.bn1"),
           "layer1": [res_p(f"head.layer1.{i}") for i in range(2)],
           "layer2": [res_p(f"head.layer2.{i}") for i in range(2)],
           "conv2": conv2d_p("head.conv2"), "bn2": ti.batch_norm_p(sd, "head.bn2")}
    p: Params = {"fcm": fcm, "tdnn": {"conv": ti.conv1d_p(sd, "xvector.tdnn.linear"),
                                      "bn": nl_p("xvector.tdnn.nonlinear")}}
    p["blocks"], p["transits"] = [], []
    for bi, n_layers in enumerate(cfg.block_layers, start=1):
        layers = []
        for j in range(n_layers):
            lb = f"xvector.block{bi}.tdnnd{j + 1}"
            cam = f"{lb}.cam_layer"
            layers.append({"nl1": nl_p(f"{lb}.nonlinear1"),
                           "lin1": ti.conv1d_p(sd, f"{lb}.linear1"),
                           "nl2": nl_p(f"{lb}.nonlinear2"),
                           "cam": {"local": ti.conv1d_p(sd, f"{cam}.linear_local"),
                                   "lin1": ti.conv1d_p(sd, f"{cam}.linear1"),
                                   "lin2": ti.conv1d_p(sd, f"{cam}.linear2")}})
        p["blocks"].append(layers)
        p["transits"].append({"nl": nl_p(f"xvector.transit{bi}.nonlinear"),
                              "lin": ti.conv1d_p(sd, f"xvector.transit{bi}.linear")})
    p["out_nl"] = nl_p("xvector.out_nonlinear")
    for cand in ("xvector.dense.linear", "xvector.dense"):
        if f"{cand}.weight" in sd:
            w = np.asarray(sd[f"{cand}.weight"])
            p["dense"] = {"lin": {"w": np.ascontiguousarray((w[..., 0] if w.ndim == 3 else w).T)},
                          "bn": nl_p("xvector.dense.nonlinear")}
            break
    else:
        raise KeyError("campplus dense layer not found")
    return ti.tensors(p, device)


def load_campplus_onnx(path: str, cfg: CampplusConfig, device=None) -> Params:
    """campplus.onnx -> the port's tree (initializer names keep the module
    paths)."""
    return campplus_from_torch(onnx_import.load_onnx_initializers(path), cfg, device)

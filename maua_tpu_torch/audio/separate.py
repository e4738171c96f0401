"""Neural music source separation, openunmix-style.

Port of `maua_tpu/audio/separate.py`: one spectrogram-mask network per
target (fc + BN + tanh, a bidirectional LSTM with a skip connection,
fc + BN + relu, fc + BN, relu mask), ratio-mask expectation-maximization
over the four targets (the mono form of norbert's Wiener filter, niter
passes) and the inverse STFT.

The networks are `OpenUnmix` modules whose state-dict names are
openunmix's own (`fc1.weight`, `bn1.running_mean`,
`lstm.weight_ih_l0_reverse`, `input_mean`, ...), so a published
checkpoint loads into them after `params_from_torch`; the BLSTM is
`nn.LSTM` (maua_tpu scans it with `lax.scan`, not a Pallas kernel).
`init_params` draws maua_tpu's numbers (numpy `default_rng(seed +
target index)`) and `state_dict_from_params` brings maua_tpu's
converted layout over: weight_ih = wi^T, weight_hh = wh^T, bias_ih = b,
bias_hh = 0, BatchNorm from scale / bias / mean / var (eps 1e-5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import spectral

TARGETS = ("vocals", "drums", "bass", "other")


@dataclasses.dataclass(frozen=True)
class UMXConfig:
    n_fft: int = 4096
    hop_length: int = 1024
    hidden: int = 512
    lstm_layers: int = 3
    max_bin: int = 1487  # umxhq's 16 kHz bandwidth crop
    niter: int = 3  # EM refinement passes

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


class OpenUnmix(nn.Module):
    """One target's mask network, in eval mode, on mono magnitudes (T, n_bins)."""

    def __init__(self, cfg: UMXConfig):
        super().__init__()
        h = cfg.hidden
        self.max_bin = cfg.max_bin
        self.input_mean = nn.Parameter(torch.zeros(cfg.max_bin))
        self.input_scale = nn.Parameter(torch.ones(cfg.max_bin))
        self.output_mean = nn.Parameter(torch.zeros(cfg.n_bins))
        self.output_scale = nn.Parameter(torch.ones(cfg.n_bins))
        self.fc1 = nn.Linear(cfg.max_bin, h, bias=False)
        self.bn1 = nn.BatchNorm1d(h)
        self.lstm = nn.LSTM(h, h // 2, num_layers=cfg.lstm_layers, bidirectional=True)
        self.fc2 = nn.Linear(2 * h, h, bias=False)
        self.bn2 = nn.BatchNorm1d(h)
        self.fc3 = nn.Linear(h, cfg.n_bins, bias=False)
        self.bn3 = nn.BatchNorm1d(cfg.n_bins)
        self.eval()

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        x = (mag[:, : self.max_bin] - self.input_mean) / self.input_scale
        x = torch.tanh(self.bn1(self.fc1(x)))
        h, _ = self.lstm(x[:, None, :])
        x = torch.relu(self.bn2(self.fc2(torch.cat([x, h[:, 0]], dim=-1))))
        x = self.bn3(self.fc3(x)) * self.output_scale + self.output_mean
        return torch.relu(x)


def _rand_linear(rng, ci, co):
    return {"w": (rng.standard_normal((ci, co)) / np.sqrt(ci)).astype(np.float32)}


def _rand_bn(rng, c):
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def _rand_lstm(rng, ci, ch):
    def gate(ci_):
        return (rng.standard_normal((ci_, 4 * ch)) / np.sqrt(ci_)).astype(np.float32)

    return {"wi": gate(ci), "wh": gate(ch), "b": np.zeros(4 * ch, np.float32)}


def state_dict_from_params(p: Dict) -> Dict[str, torch.Tensor]:
    """One target's parameters in maua_tpu's converted layout (numpy
    arrays: fc {"w": (in, out)}, bn {"scale", "bias", "mean", "var"}, lstm
    [{"fwd", "bwd": {"wi", "wh", "b"}}]) -> an OpenUnmix state dict."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {k: t(p[k]) for k in ("input_mean", "input_scale", "output_mean", "output_scale")}
    for name in ("fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = t(np.asarray(p[name]["w"]).T)
    for name in ("bn1", "bn2", "bn3"):
        bn = p[name]
        sd.update({f"{name}.weight": t(bn["scale"]), f"{name}.bias": t(bn["bias"]),
                   f"{name}.running_mean": t(bn["mean"]), f"{name}.running_var": t(bn["var"]),
                   f"{name}.num_batches_tracked": torch.zeros((), dtype=torch.long)})
    for li, layer in enumerate(p["lstm"]):
        for direction, sfx in (("fwd", f"l{li}"), ("bwd", f"l{li}_reverse")):
            d = layer[direction]
            sd[f"lstm.weight_ih_{sfx}"] = t(np.asarray(d["wi"]).T)
            sd[f"lstm.weight_hh_{sfx}"] = t(np.asarray(d["wh"]).T)
            sd[f"lstm.bias_ih_{sfx}"] = t(d["b"])
            sd[f"lstm.bias_hh_{sfx}"] = torch.zeros_like(sd[f"lstm.bias_ih_{sfx}"])
    return sd


def init_params(cfg: UMXConfig, seed: int = 0, targets=TARGETS, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random per-target state dicts on `device`, from maua_tpu's draws:
    numpy default_rng(seed + target index), in maua_tpu's order."""
    out = {}
    for t_i, target in enumerate(targets):
        rng = np.random.default_rng(seed + t_i)
        h = cfg.hidden
        layers = [{"fwd": _rand_lstm(rng, h, h // 2), "bwd": _rand_lstm(rng, h, h // 2)}
                  for _ in range(cfg.lstm_layers)]
        p = {
            "input_mean": np.zeros(cfg.max_bin, np.float32),
            "input_scale": np.ones(cfg.max_bin, np.float32),
            "output_mean": np.zeros(cfg.n_bins, np.float32),
            "output_scale": np.ones(cfg.n_bins, np.float32),
            "fc1": _rand_linear(rng, cfg.max_bin, h),
            "bn1": _rand_bn(rng, h),
            "lstm": layers,
            "fc2": _rand_linear(rng, 2 * h, h),
            "bn2": _rand_bn(rng, h),
            "fc3": _rand_linear(rng, h, cfg.n_bins),
            "bn3": _rand_bn(rng, cfg.n_bins),
        }
        out[target] = {k: v.to(device) for k, v in state_dict_from_params(p).items()}
    return out


def params_from_torch(state_dicts: Dict[str, Dict], cfg: UMXConfig) -> Dict[str, Dict[str, torch.Tensor]]:
    """{target: openunmix state dict} -> state dicts for `OpenUnmix`. The
    input statistics are cropped to max_bin, and a stereo fc1 (nb_channels
    * max_bin inputs) is summed over its channel copies, since the mono
    mean is separated (as maua_tpu folds it)."""
    out = {}
    for target, sd in state_dicts.items():
        sd = {k: torch.as_tensor(v) for k, v in sd.items()}
        w1 = sd["fc1.weight"].float()
        if w1.shape[1] != cfg.max_bin:
            w1 = w1.reshape(w1.shape[0], -1, cfg.max_bin).sum(1)
        if sd["fc3.weight"].shape[0] != cfg.n_bins:
            raise ValueError(f"{target}: fc3 has {sd['fc3.weight'].shape[0]} outputs, want {cfg.n_bins} (one "
                             f"channel); a stereo output layer has no mono form here or in maua_tpu")
        sd = {**sd, "fc1.weight": w1, "input_mean": sd["input_mean"][: cfg.max_bin],
              "input_scale": sd["input_scale"][: cfg.max_bin]}
        for name in ("bn1", "bn2", "bn3"):
            sd.setdefault(f"{name}.num_batches_tracked", torch.zeros((), dtype=torch.long))
        out[target] = sd
    return out


def _model(p: Dict[str, torch.Tensor], cfg: UMXConfig) -> OpenUnmix:
    device = p["fc1.weight"].device
    model = OpenUnmix(cfg).to(device)
    model.load_state_dict({k: v.to(device) for k, v in p.items()})
    return model


@torch.no_grad()
def target_mask(p: Dict[str, torch.Tensor], mag: torch.Tensor, cfg: UMXConfig) -> torch.Tensor:
    """Magnitudes (T, n_bins) -> the target's nonnegative mask (T, n_bins)
    (the OpenUnmix forward); p is the target's state dict."""
    return _model(p, cfg)(mag)


@torch.no_grad()
def _separate_masks(params: Dict, mag: torch.Tensor, cfg: UMXConfig) -> torch.Tensor:
    """(T, bins) -> (targets, T, bins) EM-refined ratio masks: with one
    channel the Wiener filter's niter passes reduce to v_j <- (v_j /
    sum_k v_k * |X|)^2, starting from the networks' squared magnitudes."""
    v = torch.stack([target_mask(params[t], mag, cfg) for t in TARGETS]) ** 2
    for _ in range(cfg.niter):
        v = (v / v.sum(0, keepdim=True).clamp_min(1e-10) * mag[None]) ** 2
    return v / v.sum(0, keepdim=True).clamp_min(1e-10)


@torch.no_grad()
def separate(audio, sr: int, params: Optional[Dict] = None, cfg: Optional[UMXConfig] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mono waveform -> (vocals, drums, bass, other) waveforms of its length,
    on the audio's device (a numpy waveform goes to the CPU). Without
    `params`, random networks from `init_params(cfg)`."""
    cfg = cfg or UMXConfig()
    y = torch.as_tensor(audio, dtype=torch.float32)
    if params is None:
        params = init_params(cfg, device=y.device)
    n = y.shape[-1]
    D = spectral.stft(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length)
    masks = _separate_masks(params, D.abs().T, cfg)  # (4, T, bins)
    return tuple(spectral.istft(D * masks[j].T, n_fft=cfg.n_fft, hop_length=cfg.hop_length, length=n)
                 for j in range(len(TARGETS)))

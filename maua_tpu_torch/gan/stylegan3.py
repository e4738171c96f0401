"""StyleGAN3 (alias-free, config T) generator in PyTorch, as plain functions
over a parameter dict.

Port of `maua_tpu/gan/stylegan3.py` (SG3Config, _lowpass, init_params,
mapping, synthesis_input, synthesis, make_transform_mat, StyleGAN3).
Activations are NCHW; parameters keep the JAX pytree's structure with
PyTorch layouts (conv OIHW, fc (out, in)); `maua_tpu_torch.bridge`
converts the JAX package's pytree into this form.

`synthesis` is the JAX package's fused path: each conv runs unmodulated
(one shared-weight conv for the batch), and the per-(b, c) scalars ride
the filtered nonlinearity that follows it: the conv's demodulation and
bias as its pre affine, the next conv's style as its post scale. Every
filtered nonlinearity is one launch of the CUDA kernel of
`kernels/filtered_lrelu.py` (13 per frame batch at the default config).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.filtered_lrelu import filtered_lrelu
from ..oom import is_oom_error
from ..utility import resolve_device, to_device
from . import ops
from .stylegan2 import _init_fc, _randn, fc_forward
from .wrappers import get_z_latents


@dataclasses.dataclass(frozen=True)
class SG3Config:
    z_dim: int = 512
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    num_layers: int = 14
    num_critical: int = 2
    channel_base: int = 32768
    channel_max: int = 512
    first_cutoff: float = 2.0
    first_stopband: float = 2.0 ** 2.1
    last_stopband_rel: float = 2.0 ** 0.3
    margin_size: int = 10
    filter_size: int = 6
    mapping_layers: int = 2
    conv_kernel: int = 3
    dtype: str = "float32"  # the trunk's compute dtype ('bfloat16' for speed); torgb stays f32
    torgb_bf16: bool = False  # run the final 1x1 conv in bf16 too

    def layer_plan(self):
        """Per-layer (cutoff, stopband, sampling rate, half width, size,
        channels): the alias-free-T schedule."""
        n = self.num_layers
        last_cutoff = self.img_resolution / 2
        last_stopband = last_cutoff * self.last_stopband_rel
        exponents = np.minimum(np.arange(n + 1) / (n - self.num_critical), 1.0)
        cutoffs = self.first_cutoff * (last_cutoff / self.first_cutoff) ** exponents
        stopbands = self.first_stopband * (last_stopband / self.first_stopband) ** exponents
        srates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, self.img_resolution))))
        half_widths = np.maximum(stopbands, srates / 2) - cutoffs
        sizes = srates + self.margin_size * 2
        sizes[-2:] = self.img_resolution
        channels = np.rint(np.minimum((self.channel_base / 2) / cutoffs, self.channel_max))
        channels[-1] = self.img_channels
        return cutoffs, stopbands, srates, half_widths, sizes.astype(int), channels.astype(int)

    @property
    def num_ws(self) -> int:
        return self.num_layers + 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _lowpass(numtaps: int, cutoff: float, width: float, fs: float) -> Optional[np.ndarray]:
    """Kaiser-windowed sinc lowpass (scipy firwin), f32."""
    if numtaps == 1:
        return None
    from scipy.signal import firwin, kaiser_atten, kaiser_beta

    beta = kaiser_beta(kaiser_atten(numtaps, width * 2 / fs))
    return firwin(numtaps, cutoff, window=("kaiser", beta), fs=fs).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resample_plan(cfg: SG3Config):
    """Per filtered nonlinearity i (after conv i, i < num_layers - 1):
    (up, down, up filter, down filter, output canvas size). Cached per
    config: synthesis asks for it every batch, and the filters are
    read-only."""
    cutoffs, _, srates, half_widths, sizes, _ = cfg.layer_plan()
    plan = []
    for i in range(cfg.num_layers - 1):
        in_rate, out_rate = float(srates[i]), float(srates[i + 1])
        tmp_rate = max(in_rate, out_rate) * 2
        up = int(np.rint(tmp_rate / in_rate))
        down = int(np.rint(tmp_rate / out_rate))
        up_f = _lowpass(cfg.filter_size * up if up > 1 else 1, float(cutoffs[i]), float(half_widths[i]), tmp_rate)
        down_f = _lowpass(cfg.filter_size * down if down > 1 else 1, float(cutoffs[i + 1]),
                          float(half_widths[i + 1]), tmp_rate)
        plan.append((up, down, up_f, down_f, int(sizes[i + 1])))
    return plan


def init_params(cfg: SG3Config, gen: torch.Generator) -> Dict:
    """Random parameters with the JAX package's init distributions, drawn
    from `gen` on its device (the numbers differ from JAX's)."""
    _, _, _, _, _, channels = cfg.layer_plan()
    dev = gen.device
    mapping_p = {}
    for i in range(cfg.mapping_layers):
        ci = cfg.z_dim if i == 0 else cfg.w_dim
        mapping_p[f"fc{i}"] = _init_fc(gen, ci, cfg.w_dim, lr_multiplier=0.01)
    mapping_p["w_avg"] = torch.zeros(cfg.w_dim, device=dev)

    # Fourier frequencies within the first cutoff disk
    c0 = int(channels[0])
    freqs = _randn(gen, c0, 2)
    radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
    freqs = freqs / radii * torch.exp(torch.rand(c0, 1, generator=gen, device=dev) * 0.25) * cfg.first_cutoff
    affine = _init_fc(gen, cfg.w_dim, 4)
    affine["w"] = affine["w"] * 0.0  # zero weight, bias (1, 0, 0, 0): (r_c, r_s, t_x, t_y)
    affine["b"] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    input_p = {
        "freqs": freqs,
        "phases": torch.rand(c0, generator=gen, device=dev) - 0.5,
        "affine": affine,
        "weight": _randn(gen, c0, c0, 1, 1) / math.sqrt(c0),
        "transform": torch.eye(3, device=dev),
    }
    layers = []
    for i in range(cfg.num_layers):
        ci, co = int(channels[i]), int(channels[i + 1])
        k = 1 if i == cfg.num_layers - 1 else cfg.conv_kernel
        layers.append({
            "affine": _init_fc(gen, cfg.w_dim, ci, bias_init=1.0),
            "weight": _randn(gen, co, ci, k, k),
            "bias": torch.zeros(co, device=dev),
            "magnitude_ema": torch.ones((), device=dev),
        })
    return {"mapping": mapping_p, "input": input_p, "layers": layers}


def mapping(params: Dict, z: torch.Tensor, cfg: SG3Config, truncation_psi: float = 1.0) -> torch.Tensor:
    """z (B, z_dim) -> ws (B, num_ws, w_dim) with truncation."""
    x = ops.normalize_2nd_moment(z.float())
    for i in range(cfg.mapping_layers):
        x = fc_forward(params["mapping"][f"fc{i}"], x, activation="lrelu", lr_multiplier=0.01)
    ws = x[:, None, :].repeat(1, cfg.num_ws, 1)
    w_avg = params["mapping"]["w_avg"]
    return w_avg + truncation_psi * (ws - w_avg)


def synthesis_input(params: Dict, w0: torch.Tensor, cfg: SG3Config, size: int, srate: float,
                    transform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fourier-feature input (B, C, size, size): the per-sample learned
    affine times the user transform, (B, 3, 3) or (3, 3), which the
    facade's translation and rotation drive."""
    p = params["input"]
    b = w0.shape[0]
    dev = w0.device
    t = fc_forward(p["affine"], w0)  # (B, 4): r_c, r_s, t_x, t_y
    t = t / t[:, :2].norm(dim=1, keepdim=True).clamp_min(1e-8)
    m_r = torch.zeros(b, 3, 3, device=dev)
    m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
    m_r[:, 2, 2] = 1.0
    m_t = torch.eye(3, device=dev).repeat(b, 1, 1)
    m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
    user = p["transform"] if transform is None else transform.to(dev, torch.float32)
    if user.dim() == 2:
        user = user[None].repeat(b, 1, 1)
    transforms = m_r @ m_t @ user  # (B, 3, 3)

    freqs = p["freqs"][None] @ transforms[:, :2, :2]  # (B, C, 2)
    phases = p["phases"][None] + torch.einsum("bcd,bd->bc", freqs, transforms[:, :2, 2])
    # amplitude rolloff near the band limit
    amp = 1.0 - ((freqs.norm(dim=-1) - cfg.first_cutoff) / (srate / 2 - cfg.first_cutoff)).clamp(0, 1)  # (B, C)

    theta = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5) / srate - (size / srate) / 2
    gx = theta[None, None, :] * freqs[:, :, 0, None]  # (B, C, X)
    gy = theta[None, None, :] * freqs[:, :, 1, None]  # (B, C, Y)
    field = gy[:, :, :, None] + gx[:, :, None, :] + phases[:, :, None, None]
    feats = torch.sin(field * (2 * math.pi)) * amp[:, :, None, None]  # (B, C, H, W)
    return F.conv2d(feats, p["weight"])


def synthesis(params: Dict, ws: torch.Tensor, cfg: SG3Config, transform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ws (B, num_ws, w_dim) -> image (B, C, H, W), f32, about [-1, 1]."""
    _, _, srates, _, sizes, channels = cfg.layer_plan()
    plan = resample_plan(cfg)
    x = synthesis_input(params, ws[:, 0], cfg, int(sizes[0]), float(srates[0]), transform)

    # styles per layer up front; torgb folds its fan-in gain into its styles
    n = cfg.num_layers
    styles_all = []
    for i, layer in enumerate(params["layers"]):
        s = fc_forward(layer["affine"], ws[:, i + 1])
        if i == n - 1:
            s = s * (1.0 / math.sqrt(int(channels[i])))
        styles_all.append(s)

    for i, layer in enumerate(params["layers"]):
        is_torgb = i == n - 1
        x = x.to(cfg.compute_dtype if (not is_torgb or cfg.torgb_bf16) else torch.float32)
        w = layer["weight"]
        if not is_torgb:
            w = w * (1.0 / math.sqrt(w[0].numel()))
        w = w / layer["magnitude_ema"].sqrt().clamp_min(1e-8)
        if i == 0:
            x = x * styles_all[0].to(x.dtype)[:, :, None, None]
        # x already carries this conv's style (above, or the previous
        # nonlinearity's post scale): one shared-weight conv for the batch
        if w.shape[-1] == 1:
            y = torch.einsum("bchw,oc->bohw", x, w[:, :, 0, 0].to(x.dtype))
        else:
            y = F.conv2d(x, w.to(x.dtype), padding=w.shape[-1] // 2)
        if is_torgb:
            x = y + layer["bias"].to(y.dtype)[None, :, None, None]
            break
        demod = torch.rsqrt(styles_all[i].float().square() @ w.float().square().sum(dim=(2, 3)).t() + 1e-8)
        up, down, up_f, down_f, out_size = plan[i]
        bias = layer["bias"].float()[None].expand(x.shape[0], -1)
        # centre crop (inside the kernel, which writes only the kept window) or pad to the next canvas
        h = y.shape[2] * up // down
        o = (h - out_size) // 2
        crop = (o, o, out_size, out_size) if h > out_size else None
        x = filtered_lrelu(y.contiguous(), up_f, down_f, up, down, pre_scale=demod, pre_add=bias,
                           post_scale=styles_all[i + 1], crop=crop)
        if h < out_size:
            o = (out_size - h) // 2
            x = F.pad(x, (o, out_size - h - o, o, out_size - h - o))
    return x.float()


def make_transform_mat(translate: Tuple[float, float], angle_deg: float) -> torch.Tensor:
    """The inverse of a rotation + translation, in float64, as f32 (3, 3):
    the user transform that the facade's translation and rotation set."""
    s = math.sin(angle_deg / 360.0 * math.pi * 2)
    c = math.cos(angle_deg / 360.0 * math.pi * 2)
    m = np.array([[c, s, translate[0]], [-s, c, translate[1]], [0, 0, 1]], np.float64)
    try:
        m = np.linalg.inv(m)
    except np.linalg.LinAlgError:
        m = np.linalg.pinv(m)
    return torch.from_numpy(m.astype(np.float32))


class StyleGAN3:
    """Mapper + synthesizer facade over the functional generator.

    `model_file` loads an alias-free checkpoint (any format of
    `gan/load.py`) with `dtype` as its trunk's compute dtype, in place of
    `cfg`; without one, `params` (the port's layout, see
    `maua_tpu_torch.bridge`) takes given parameters, and otherwise they are
    drawn from a torch.Generator seeded with `seed` on `device`. The
    parameters live on `device`. Frames render at the config's native
    resolution."""

    def __init__(self, cfg: Optional[SG3Config] = None, params: Optional[Dict] = None,
                 model_file: Optional[str] = None, output_size=None, device=None, seed: int = 0,
                 dtype: str = "float32"):
        self.device = resolve_device(device)
        if model_file not in (None, "None"):
            from .load import load_network

            params, cfg = load_network(model_file, dtype=dtype)
            if not isinstance(cfg, SG3Config):
                raise ValueError(f"{model_file} is not an alias-free checkpoint")
        self.cfg = cfg or SG3Config()
        if params is not None:
            self.params = to_device(params, self.device)
        else:
            self.params = init_params(self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.num_ws = self.cfg.num_ws
        self.w_dim = self.cfg.w_dim
        self.z_dim = self.cfg.z_dim
        self.res = self.cfg.img_resolution
        if output_size and tuple(output_size) != (self.res, self.res):
            raise NotImplementedError("StyleGAN3 output resizing is not ported yet; "
                                      f"frames render at {self.res}x{self.res}")

    def get_z_latents(self, seeds) -> torch.Tensor:
        return torch.from_numpy(get_z_latents(seeds, self.z_dim)).to(self.device)

    @torch.no_grad()
    def mapper(self, z=None, truncation: float = 1.0, latent_z=None, c=None, class_conditioning=None):
        z = z if z is not None else latent_z  # patch pipelines pass the reference kwarg name
        return mapping(self.params, torch.as_tensor(z, device=self.device), self.cfg, truncation)

    @torch.no_grad()
    def synthesizer(self, latents, translation=None, rotation=None) -> torch.Tensor:
        transform = None
        if translation is not None or rotation is not None:
            t = np.asarray(translation if translation is not None else (0.0, 0.0), np.float64).reshape(-1)
            r = float(np.asarray(rotation if rotation is not None else 0.0).reshape(-1)[0])
            transform = make_transform_mat((float(t[0]), float(t[1])), r)
        return synthesis(self.params, torch.as_tensor(latents, device=self.device), self.cfg, transform)

    def __call__(self, z, truncation: float = 1.0, translation=None, rotation=None) -> torch.Tensor:
        return self.synthesizer(self.mapper(z, truncation), translation, rotation)

    def render(
        self,
        latent_w_plus: torch.Tensor,  # (T, num_ws, w_dim)
        translation=None,  # (T, 2)
        rotation=None,  # (T,) degrees
        batch_size: int = 8,
        postprocess=None,
        pix_fmt: str = "rgb24",
        **_ignored,  # the SG2 renderer's noises and zoom: SG3 has no noise inputs or zoom
    ) -> Iterator[np.ndarray]:
        """Yield uint8 frames, synthesized `batch_size` at a time: (H, W, C)
        with pix_fmt "rgb24", planar I420 (3H/2, W) with "yuv420p";
        per-frame translation and rotation drive the Fourier input
        transform. `postprocess` gets each batch as (B, H, W, C), the layout
        of maua_tpu. Frames are converted on the device and delivered by
        `ops.video.pipelined_frames`. The tail batch is padded with its last
        frame. A device out-of-memory error halves the batch and retries."""
        from ..ops.video import pipelined_frames

        latents = torch.as_tensor(latent_w_plus, device=self.device)
        T = latents.shape[0]
        mats = None
        if translation is not None or rotation is not None:
            tr = np.zeros((T, 2)) if translation is None else _numpy(translation).reshape(T, 2)
            ro = np.zeros((T,)) if rotation is None else _numpy(rotation).reshape(-1)
            mats = torch.stack([make_transform_mat((float(tr[i, 0]), float(tr[i, 1])), float(ro[i]))
                                for i in range(T)]).to(self.device)

        @torch.no_grad()
        def batches():
            nonlocal batch_size
            lo = 0
            while lo < T:
                hi = min(lo + batch_size, T)
                pad = batch_size - (hi - lo)

                def take(arr):
                    if arr is None:
                        return None
                    sl = arr[lo:hi]
                    return torch.cat([sl, sl[-1:].repeat_interleave(pad, dim=0)], dim=0) if pad else sl

                try:
                    imgs = synthesis(self.params, take(latents), self.cfg, take(mats))
                except Exception as e:  # noqa: BLE001 - filtered below
                    if not is_oom_error(e) or batch_size <= 1:
                        raise
                    batch_size = max(batch_size // 2, 1)
                    print(f"device OOM during render; retrying with batch_size={batch_size}")
                    continue
                imgs = imgs.permute(0, 2, 3, 1)  # NHWC, the layout a patch's process_outputs gets in maua_tpu
                if postprocess is not None:
                    imgs = postprocess(imgs)
                yield ((imgs.clamp(-1, 1) + 1.0) * 127.5).clamp(0, 255).to(torch.uint8), hi - lo
                lo = hi

        yield from pipelined_frames(batches(), pix_fmt)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

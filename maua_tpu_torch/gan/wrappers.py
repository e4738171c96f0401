"""High-level StyleGAN2 API: arbitrary output size, latent-space camera
motion, noise pyramids, and the batched render loop.

Port of `maua_tpu/gan/wrappers.py` (layer_names, RenderConfig,
synthesize with its motion, make_noise_pyramid, get_z_latents,
StyleGAN2 with mapper / synthesizer / render and the synthesizer's
dispatch to the space-to-depth route of `fast_synthesis.py`,
get_generator_class). Noise maps and per-frame
inputs are NCHW here: a noise video is (T, 1, H, W).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops import warp as W
from ..oom import is_oom_error
from ..utility import resolve_device, to_device
from . import ops
from .stylegan2 import SG2Config, init_params, layer_noise_input, mapping, synthesis_layer, torgb_layer


def layer_names(cfg: SG2Config):
    """Per-conv layer names, with the reference's duplicate first entry for b4."""
    names = []
    for c, res in enumerate(sorted(list(cfg.block_resolutions) * 2)):
        names.append(f"b{res}.conv{1 if res == 4 else c % 2}")
    return names


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    output_size: Optional[Tuple[int, int]] = None  # (W, H)
    strategy: str = "stretch"  # 'stretch' | 'pad-<how>-<where>'
    layer: int = 0
    translation_layer: int = 7
    zoom_layer: int = 7
    rotation_layer: int = 7
    zoom_center: Optional[Tuple[float, float]] = None
    rotation_center: Optional[Tuple[float, float]] = None
    resize_noise: bool = True


def _resize_plan(cfg: SG2Config, rcfg: RenderConfig):
    """(resize layer index, per-layer target (H, W)), (None, output (H, W))
    when the target rounds below one pixel at that layer, or None."""
    if rcfg.output_size is None:
        return None
    out_w, out_h = rcfg.output_size
    if (out_w, out_h) == (cfg.img_resolution, cfg.img_resolution):
        return None
    name = layer_names(cfg)[rcfg.layer]
    res = int(name.split(".")[0][1:])
    lay_mult = cfg.img_resolution // res
    target = (int(round(out_h / lay_mult)), int(round(out_w / lay_mult)))
    if min(target) < 1:
        return None, (out_h, out_w)
    return rcfg.layer, target


def _pad_index(size: int, before: int, after: int, how: str, device) -> torch.Tensor:
    """Source indices of a 1-D pad by numpy's rules (`jnp.pad` modes reflect,
    edge, wrap), for pads of any size: the reflection has period 2 (size - 1)."""
    idx = torch.arange(-before, size + after, device=device)
    if how == "reflect":
        return W._reflect_index(idx, size)
    if how == "circular":
        return idx % size
    return idx.clamp(0, size - 1)


def _apply_strategy(x: torch.Tensor, target_hw: Tuple[int, int], strategy: str,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Feature resize or pad to target_hw; with `gen`, add channel-stat-matched noise."""
    th, tw = target_hw
    if strategy == "stretch":
        out = W.resize_bicubic(x, (th, tw))
    elif strategy.startswith("pad"):
        _, how, where = strategy.split("-")
        h, w = x.shape[2], x.shape[3]
        pad_h, pad_w = th - h, tw - w
        if where == "out":
            padding = (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2)
        elif where == "left":
            padding = (pad_w, 0, pad_h // 2, pad_h - pad_h // 2)
        elif where == "right":
            padding = (0, pad_w, pad_h // 2, pad_h - pad_h // 2)
        elif where == "top":
            padding = (pad_w // 2, pad_w - pad_w // 2, pad_h, 0)
        else:  # bottom
            padding = (pad_w // 2, pad_w - pad_w // 2, 0, pad_h)
        if how in ("reflect", "replicate", "circular"):
            l, r, t, b = padding
            out = x.index_select(2, _pad_index(h, t, b, how, x.device))
            out = out.index_select(3, _pad_index(w, l, r, how, x.device))
        else:
            out = torch.nn.functional.pad(x, padding, value=float(how))
    else:
        raise ValueError(f"Resize strategy not found: {strategy}")
    if gen is not None:
        mean = out.mean(dim=(0, 2, 3), keepdim=True)
        std = out.std(dim=(0, 2, 3), keepdim=True, correction=0)
        n = torch.randn((1,) + tuple(out.shape[1:]), generator=gen, device=out.device).to(out.dtype)
        out = out + (n * std + mean)
    return out


def apply_motion(x: torch.Tensor, idx: int, rcfg: RenderConfig, translation=None, zoom=None,
                 rotation=None) -> torch.Tensor:
    """Translate, zoom and rotate the features x at per-conv layer `idx`
    where it is the layer `rcfg` names for each (each in f32)."""
    if translation is not None and idx == rcfg.translation_layer:
        h, w = x.shape[2], x.shape[3]
        t = torch.as_tensor(translation, dtype=torch.float32, device=x.device)
        t = t * torch.tensor([w, h], dtype=torch.float32, device=x.device)
        x = W.translate(x.float(), t).to(x.dtype)
    if zoom is not None and idx == rcfg.zoom_layer:
        x = W.zoom(x.float(), zoom, rcfg.zoom_center).to(x.dtype)
    if rotation is not None and idx == rcfg.rotation_layer:
        x = W.rotate(x.float(), rotation, rcfg.rotation_center).to(x.dtype)
    return x


def synthesize(
    params: Dict,
    ws: torch.Tensor,
    cfg: SG2Config,
    rcfg: RenderConfig = RenderConfig(),
    translation: Optional[torch.Tensor] = None,
    zoom: Optional[torch.Tensor] = None,
    rotation: Optional[torch.Tensor] = None,
    noises: Optional[Dict] = None,
    noise_mode: str = "const",
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Synthesis with output resizing, translate/zoom/rotate at chosen
    layers and explicit per-frame noise. ws (B, num_ws, w_dim) -> (B, C, H, W).

    Random draws (noise_mode "random", refills of resized layers) come
    from `gen`, a generator on ws's device (seed 0 when None)."""
    syn = params["synthesis"]
    rfilter = ops.setup_filter(list(cfg.resample_filter))
    batch = ws.shape[0]
    if gen is None:
        gen = torch.Generator(device=ws.device).manual_seed(0)
    plan = _resize_plan(cfg, rcfg)
    refill = gen if rcfg.resize_noise else None

    def maybe_motion(x, idx):
        return apply_motion(x, idx, rcfg, translation, zoom, rotation)

    def layer_noise(p, name, shape_hw):
        if noise_mode == "none":
            return None
        if noises is not None and name in noises:
            n = layer_noise_input(noises[name])
            if tuple(n.shape[2:]) != shape_hw:
                n = W.resize_bicubic(n, shape_hw)
            return n
        if noise_mode == "random":
            return torch.randn((batch, 1) + shape_hw, generator=gen, device=ws.device)
        nc = p.get("noise_const")
        if nc is not None and tuple(nc.shape) == shape_hw:
            return nc[None, None]
        return torch.randn((1, 1) + shape_hw, generator=gen, device=ws.device)

    li = 1  # the reference's duplicate entry makes b8.conv0 layer 2
    x = img = None
    w_idx = 0
    for res in cfg.block_resolutions:
        block = syn[f"b{res}"]
        dtype = cfg.compute_dtype(res)
        num_conv = 1 if res == 4 else 2
        block_ws = ws[:, w_idx : w_idx + num_conv + 1]

        if res == 4:
            x = block["const"][None].to(dtype).repeat(batch, 1, 1, 1)
            if plan is not None and plan[0] is not None and plan[0] <= 1:
                x = _apply_strategy(x, plan[1], rcfg.strategy, refill)
            n = layer_noise(block["conv1"], "b4.conv1", tuple(x.shape[2:]))
            x = synthesis_layer(block["conv1"], x, block_ws[:, 0], 1, rfilter, cfg, n)
            x = maybe_motion(x, 0)
            li = 2
        else:
            x = x.to(dtype)
            for ci, cname in enumerate(["conv0", "conv1"]):
                up = 2 if ci == 0 else 1
                out_hw = (x.shape[2] * up, x.shape[3] * up)
                n = layer_noise(block[cname], f"b{res}.{cname}", out_hw)
                x = synthesis_layer(block[cname], x, block_ws[:, ci], up, rfilter, cfg, n)
                if plan is not None and plan[0] is not None and plan[0] == li and plan[0] > 1:
                    x = _apply_strategy(x, plan[1], rcfg.strategy, refill)
                x = maybe_motion(x, li)
                li += 1

        if img is not None:
            img = ops.upsample2d(img, rfilter)
        if res == cfg.img_resolution or cfg.architecture == "skip":
            y = torgb_layer(block["torgb"], x, block_ws[:, num_conv], cfg)
            if img is not None and img.shape[2:] != y.shape[2:]:
                img = W.resize_bicubic(img, tuple(y.shape[2:]))
            img = img + y.to(img.dtype) if img is not None else y.float()
        w_idx += num_conv
    if plan is not None:
        out_w, out_h = rcfg.output_size
        if tuple(img.shape[2:]) != (out_h, out_w):
            img = W.resize_bicubic(img, (out_h, out_w))
    return img.float()


def make_noise_pyramid(cfg: SG2Config, noise: torch.Tensor, layer_limit: int = 8,
                       rcfg: RenderConfig = RenderConfig()) -> Dict[str, torch.Tensor]:
    """Resize a (T, 1, H, W) noise video to each synthesis layer's size,
    std-normalized per frame. Returns {layer_name: (T, 1, h, w)}."""
    noises = {}
    plan = _resize_plan(cfg, rcfg)
    for l, name in enumerate(layer_names(cfg)[1:]):
        if l > layer_limit:
            continue
        res = int(name.split(".")[0][1:])
        h = w = res
        if plan is not None and plan[0] is not None:
            rl_res = int(layer_names(cfg)[plan[0]].split(".")[0][1:])
            if res >= rl_res:
                scale = res // rl_res
                h, w = plan[1][0] * scale, plan[1][1] * scale
        n = W.resize_bicubic(noise, (h, w))
        n = n / n.std(dim=(1, 2, 3), keepdim=True, correction=0).clamp_min(1e-8)
        noises[name] = n
    return noises


def get_z_latents(seeds, z_dim: int = 512) -> np.ndarray:
    """Seed spec ('1,3,5-10') -> z latents, numpy RandomState per seed."""
    seed_list = sum(
        [
            ([int(s)] if "-" not in s else list(range(int(s.split("-")[0]), int(s.split("-")[1]))))
            for s in str(seeds).split(",")
        ],
        [],
    )
    return np.concatenate([np.random.RandomState(s).randn(1, z_dim) for s in seed_list]).astype(np.float32)


class StyleGAN2:
    """Mapper + synthesizer facade over the functional generator.

    `model_file` loads a checkpoint (any format of `gan/load.py`) with
    `dtype` as its compute dtype; without one, `params` (the port's layout,
    see `maua_tpu_torch.bridge`) with `cfg` takes given parameters, and
    otherwise they are drawn from a torch.Generator seeded with `seed` on
    `device`. The parameters live on `device`."""

    def __init__(
        self,
        model_file: Optional[str] = None,
        output_size: Optional[Tuple[int, int]] = None,
        strategy: str = "stretch",
        layer: int = 0,
        dtype: str = "bfloat16",
        cfg: Optional[SG2Config] = None,
        params: Optional[Dict] = None,
        device=None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.model_file = model_file if model_file not in (None, "None") else None
        if self.model_file is not None:
            from .load import load_network

            params, self.cfg = load_network(model_file, dtype=dtype)
            self.params = to_device(params, self.device)
        elif params is not None and cfg is not None:
            self.cfg = cfg
            self.params = to_device(params, self.device)
        else:
            self.cfg = cfg or SG2Config(dtype=dtype)
            self.params = init_params(self.cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.rcfg = RenderConfig(output_size=output_size, strategy=strategy, layer=layer)
        self.z_dim = self.cfg.z_dim
        self.w_dim = self.cfg.w_dim
        self.num_ws = self.cfg.num_ws
        self.res = self.cfg.img_resolution
        # the space-to-depth route (gan/fast_synthesis.py, exact) for the forward
        # without an output resize; its plan is probed at the first such call
        self._fast_plan = None
        self._fast_synth = None
        self._vanilla = self.rcfg.output_size in (None, (self.res, self.res))

    def _get_fast(self):
        """The s2d synthesis closure of this model, built at the first call,
        or False where the net has resnet blocks (which the route lacks) or no
        block is narrow enough for it."""
        if self._fast_synth is None:
            self._fast_synth = False
            if self.cfg.architecture != "resnet":
                from .fast_synthesis import make_fast_synthesis

                fn, self._fast_plan = make_fast_synthesis(self.params, self.cfg)
                if self._fast_plan["blocks"]:
                    self._fast_synth = fn
        return self._fast_synth

    def _motion_fast_ok(self, translation, zoom, rotation) -> bool:
        """Motion can take the s2d route when every active transform's layer
        lies in the plain head, below the s2d tail (the default layer 7
        does for 1024^2 nets)."""
        from .fast_synthesis import motion_layer_bound

        used = [layer for v, layer in ((translation, self.rcfg.translation_layer), (zoom, self.rcfg.zoom_layer),
                                       (rotation, self.rcfg.rotation_layer)) if v is not None]
        return not used or max(used) < motion_layer_bound(self._fast_plan, self.cfg)

    def get_z_latents(self, seeds) -> torch.Tensor:
        return torch.from_numpy(get_z_latents(seeds, self.z_dim)).to(self.device)

    @torch.no_grad()
    def mapper(self, z=None, c=None, truncation: float = 1.0, latent_z=None, class_conditioning=None):
        z = z if z is not None else latent_z
        c = c if c is not None else class_conditioning
        return mapping(self.params, torch.as_tensor(z, device=self.device), self.cfg, c, truncation_psi=truncation)

    def get_w_latents(self, seeds, truncation: float = 1.0) -> torch.Tensor:
        return self.mapper(self.get_z_latents(seeds), truncation=truncation)

    @torch.no_grad()
    def synthesizer(self, latents, translation=None, zoom=None, rotation=None, noises=None,
                    noise_mode: str = "const", gen=None) -> torch.Tensor:
        """Images (B, C, H, W) from w+ latents: through the s2d route when
        the output is not resized, the noise is const (or given) and any
        motion sits in the plain head, as maua_tpu dispatches; otherwise
        through `synthesize`."""
        if self._vanilla and noise_mode == "const":
            fast = self._get_fast()
            if fast and self._motion_fast_ok(translation, zoom, rotation):
                return fast(torch.as_tensor(latents, device=self.device), noise_mode="const", noises=noises,
                            gen=gen, translation=translation, zoom=zoom, rotation=rotation, rcfg=self.rcfg)
        return synthesize(self.params, latents, self.cfg, self.rcfg, translation=translation, zoom=zoom,
                          rotation=rotation, noises=noises, noise_mode=noise_mode, gen=gen)

    def __call__(self, z, c=None, truncation: float = 1.0, **kw) -> torch.Tensor:
        return self.synthesizer(self.mapper(z, c, truncation), **kw)

    def make_noise_pyramid(self, noise, layer_limit: int = 8):
        return make_noise_pyramid(self.cfg, noise, layer_limit, self.rcfg)

    def render(
        self,
        latents: torch.Tensor,  # (T, num_ws, w_dim)
        noises: Optional[Dict] = None,  # {name: (T, 1, h, w)}
        translation: Optional[torch.Tensor] = None,  # (T, 2)
        zoom: Optional[torch.Tensor] = None,  # (T,)
        rotation: Optional[torch.Tensor] = None,  # (T,)
        batch_size: int = 8,
        postprocess=None,
        pix_fmt: str = "rgb24",
    ) -> Iterator[np.ndarray]:
        """Yield uint8 frames, synthesized `batch_size` at a time: (H, W, C)
        with pix_fmt "rgb24", planar I420 (3H/2, W) with "yuv420p".
        `postprocess` gets each batch as (B, H, W, C) in [-1, 1], the layout
        of maua_tpu. Frames are converted on the device and delivered by
        `ops.video.pipelined_frames`, which copies a batch while the next
        ones are synthesized. The tail batch is padded with its last frame.
        A device out-of-memory error halves the batch and retries."""
        from ..ops.video import pipelined_frames

        T = latents.shape[0]

        def batches():
            nonlocal batch_size
            lo = 0
            while lo < T:
                hi = min(lo + batch_size, T)
                pad = batch_size - (hi - lo)

                def take(arr):
                    if arr is None:
                        return None
                    sl = torch.as_tensor(arr[lo:hi], device=self.device)
                    if pad:
                        sl = torch.cat([sl, sl[-1:].repeat_interleave(pad, dim=0)], dim=0)
                    return sl

                try:
                    imgs = self.synthesizer(
                        take(latents), translation=take(translation), zoom=take(zoom), rotation=take(rotation),
                        noises=None if noises is None else {k: take(v) for k, v in noises.items()},
                    )
                except Exception as e:  # noqa: BLE001 - filtered below
                    if not is_oom_error(e) or batch_size <= 1:
                        raise
                    batch_size = max(batch_size // 2, 1)
                    print(f"device OOM during render; retrying with batch_size={batch_size}")
                    continue
                imgs = imgs.permute(0, 2, 3, 1)  # NHWC, the layout a patch's process_outputs gets in maua_tpu
                if postprocess is not None:
                    imgs = postprocess(imgs)
                yield ((imgs + 1.0) * 127.5).clamp(0, 255).to(torch.uint8), hi - lo
                lo = hi

        yield from pipelined_frames(batches(), pix_fmt)


def get_generator_class(architecture: str):
    """The facade class of a generator architecture name."""
    if architecture in ("stylegan2", "stylegan"):
        return StyleGAN2
    if architecture == "stylegan3":
        from .stylegan3 import StyleGAN3

        return StyleGAN3
    raise ValueError(f"unknown generator architecture {architecture}")

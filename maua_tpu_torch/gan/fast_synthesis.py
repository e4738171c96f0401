"""Space-to-depth (s2d) route of StyleGAN2 synthesis.

Port of `maua_tpu/gan/fast_synthesis.py`. Every op
of a synthesis block's tail (transposed conv, FIR resample, 3x3 conv,
1x1 torgb, image upsample) is a zero-padded linear convolution, so each
layer equals a convolution between 2x2-cell grids at half resolution
with 4x the channels. The blocks with fewer than `min_channels` channels
(b512 and b1024 of a 1024^2 config-f net) run that way: no FIR pass and
no transposed conv, about 4x the multiply-adds of the plain convs, on
wide channels. The cell kernels are found once per model by impulse
probing numpy copies of the plain ops, so the route is exact up to
roundoff; the style modulation stays outside the convs, as input and
output scales, exactly as in `ops.modulated_conv2d`.

Packing, NCHW and phase-major: `space_to_depth(x)[b, (p*2+q)*C + c, i, j]
= x[b, c, 2i+p, 2j+q]`; p is the row phase, q the column phase and c
the channel, so the channel axis holds four copies of the C channels,
one per phase. The probe ops and the plan's kernels keep the JAX
package's NHWC / HWIO numpy layout (a plan equals maua_tpu's); the
convs take them as OIHW tensors (`device_plan`).

After each s2d conv the fused epilogue kernel (`kernels/epilogue.py`)
applies the demodulation and bias tiled 4x, the cell noise as four
groups (one per phase) and, after conv0, conv1's input style.

The opt-in int8 plan (`quantize_plan`, W8A8): the tail's cell convs run int8
x int8 -> int32 through the kernel of `kernels/conv_i8.py`, on activations
quantized per channel against amax calibrated over a batch, with weights
quantized per output channel; the dequant scales fold into the epilogue's
demodulation, and conv0's epilogue writes conv1's int8 operand directly
(`quant_out`). Not exact: maua_tpu's tests hold it above 30 dB PSNR from the
f32 synthesis.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.conv_i8 import conv_i8
from ..kernels.epilogue import modconv_epilogue
from . import ops
from .stylegan2 import SG2Config, _layer_noise, fc_forward, layer_noise_input, mapping, synthesis_layer, torgb_layer

_QUANT_KEYS = ("q0", "q1", "s0", "s1", "a0", "a1")


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), phase-major (see the module docstring)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, 4C, H, W) -> (B, C, 2H, 2W), the inverse of `space_to_depth`."""
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, 2 * h, 2 * w)


# ------------------------------------------------- numpy probe ops
# numpy copies of the plain conv paths in NHWC / HWIO, used only to probe
# the cell kernels when a plan is built (the parity tests hold the whole
# route against the plain synthesis)


def _np_pad_crop(x, pads):
    (py0, py1), (px0, px1) = pads
    x = np.pad(x, ((0, 0), (max(py0, 0), max(py1, 0)), (max(px0, 0), max(px1, 0)), (0, 0)))
    h, w = x.shape[1], x.shape[2]
    return x[:, max(-py0, 0) : h - max(-py1, 0), max(-px0, 0) : w - max(-px1, 0), :]


def _np_corr(x, w, pads=((0, 0), (0, 0)), lhs_dilation=1):
    """Correlation of x (N, H, W, Ci) with w (kh, kw, Ci, Co), input dilated
    by lhs_dilation: one matrix product per tap."""
    n, h, wd, ci = x.shape
    if lhs_dilation > 1:
        up = np.zeros((n, (h - 1) * lhs_dilation + 1, (wd - 1) * lhs_dilation + 1, ci), x.dtype)
        up[:, ::lhs_dilation, ::lhs_dilation, :] = x
        x = up
    x = _np_pad_crop(x, pads)
    kh, kw = w.shape[0], w.shape[1]
    oh, ow = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    out = np.zeros((n, oh, ow, w.shape[3]), np.float32)
    for i in range(kh):
        for j in range(kw):
            out += x[:, i : i + oh, j : j + ow, :] @ w[i, j]
    return out


def _np_upfirdn2d(x, f, up=1, padding=(0, 0, 0, 0), gain=1.0):
    """ops.upfirdn2d without down-sampling, in NHWC (the zero insertion
    appends trailing zeros)."""
    padx0, padx1, pady0, pady1 = padding
    c = x.shape[-1]
    f2 = (f * (gain ** (f.ndim / 2))).astype(np.float32)
    n, h, wd, _ = x.shape
    if up > 1:
        z = np.zeros((n, h * up, wd * up, c), x.dtype)
        z[:, ::up, ::up] = x
        x = z
    x = _np_pad_crop(x, ((pady0, pady1), (padx0, padx1)))
    kh, kw = f2.shape
    oh, ow = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    y = np.zeros((n, oh, ow, c), np.float32)
    for i in range(kh):
        for j in range(kw):
            y += x[:, i : i + oh, j : j + ow, :] * f2[i, j]
    return y


def _np_conv2d_resample_up2(x, w, f, padding):
    """ops.conv2d_resample with up=2 in NHWC / HWIO."""
    kh, kw = w.shape[0], w.shape[1]
    fw, fh = f.shape[-1], f.shape[0]
    px0 = px1 = py0 = py1 = padding
    px0 += (fw + 1) // 2
    px1 += (fw - 2) // 2
    py0 += (fh + 1) // 2
    py1 += (fh - 2) // 2
    px0 -= kw - 1
    px1 -= kw - 2
    py0 -= kh - 1
    py1 -= kh - 2
    pxt = max(min(-px0, -px1), 0)
    pyt = max(min(-py0, -py1), 0)
    y = _np_corr(x, w[::-1, ::-1], pads=((kh - 1 - pyt, kh - 1 - pyt), (kw - 1 - pxt, kw - 1 - pxt)), lhs_dilation=2)
    return _np_upfirdn2d(y, f, padding=(px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt), gain=4.0)


def _np_upsample2d(x, f):
    fw, fh = f.shape[-1], f.shape[0]
    p = ((fw + 1) // 2, (fw - 2) // 2, (fh + 1) // 2, (fh - 2) // 2)
    return _np_upfirdn2d(x, f, up=2, padding=p, gain=4.0)


def _extract_kernel(op, c_in: int, in_cell: int, out_cell: int, grid: int = 5, support: int = 5) -> np.ndarray:
    """Impulse-probe a linear op that commutes with cell shifts into an
    HWIO cell kernel.

    op maps (N, grid*in_cell, grid*in_cell, c_in) to a full-resolution
    NHWC output; in_cell / out_cell are the pixels per cell side. Returns
    (kh, kw, c_in*in_cell^2, c_out*out_cell^2), phase-major on both sides,
    with all-zero outer rings trimmed. The probe grid needs only the
    support's cells: the ops are zero-padded, so the response does not
    depend on the grid's size (maua_tpu probes 12 cells a side; 5 give the
    same numbers at a sixth of the work)."""
    n_basis = c_in * in_cell * in_cell
    h = grid * in_cell
    x = np.zeros((n_basis, h, h, c_in), np.float32)
    center = grid // 2
    b = 0
    for p in range(in_cell):
        for q in range(in_cell):
            for c in range(c_in):
                x[b, center * in_cell + p, center * in_cell + q, c] = 1.0
                b += 1
    y = np.asarray(op(x))  # (n_basis, grid*out_cell, grid*out_cell, c_out)
    c_out = y.shape[-1]
    out_grid = y.shape[1] // out_cell
    y = y.reshape(n_basis, out_grid, out_cell, out_grid, out_cell, c_out)
    y = y.transpose(0, 1, 3, 2, 4, 5).reshape(n_basis, out_grid, out_grid, out_cell * out_cell * c_out)

    # the response to an impulse at cell `center` around that cell; a response
    # at offset d is the correlation tap at -d, hence the flip
    r = support // 2
    K = np.zeros((support, support, n_basis, y.shape[-1]), np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yy, xx = center + dy, center + dx
            if 0 <= yy < y.shape[1] and 0 <= xx < y.shape[2]:
                K[r + dy, r + dx] = y[:, yy, xx, :]
    K = K[::-1, ::-1]
    while K.shape[0] > 1 and not (np.any(K[0]) or np.any(K[-1]) or np.any(K[:, 0]) or np.any(K[:, -1])):
        K = K[1:-1, 1:-1]
    return K.copy()  # C order: the flipped view may keep negative strides


def _extract_conv_kernel(op, w: np.ndarray, in_cell: int, out_cell: int) -> np.ndarray:
    """`_extract_kernel` of x -> op(x, w), where op is linear in x and mixes
    channels only through the HWIO conv weight w (kh, kw, ci, co). It probes
    one input channel and carries w's (ci, co) pairs as ci*co output
    channels: the numbers of probing every input channel (each output sums
    the same products in the same order, less the exact zeros of the other
    channels), at 1/ci of the work."""
    ci, co = w.shape[2], w.shape[3]
    k = _extract_kernel(lambda x: op(x, w.reshape(w.shape[0], w.shape[1], 1, ci * co)), 1, in_cell, out_cell)
    kh, kw = k.shape[:2]
    p_in, p_out = in_cell * in_cell, out_cell * out_cell
    k = k.reshape(kh, kw, p_in, p_out, ci, co).transpose(0, 1, 2, 4, 3, 5)
    return np.ascontiguousarray(k.reshape(kh, kw, p_in * ci, p_out * co))


def _hwio(weight: torch.Tensor) -> np.ndarray:
    """An OIHW parameter as an f32 HWIO numpy array."""
    return np.ascontiguousarray(weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0))


def build_fast_plan(params: Dict, cfg: SG2Config, min_channels: int = 128) -> Dict:
    """Probe the cell kernels of every block with fewer than `min_channels`
    channels. Returns {"blocks": {res: {"k0", "k1", ["kt"], "kimg",
    "w0_sq", "w1_sq"}}, "min_channels": ...} with HWIO numpy kernels, as
    maua_tpu's plan holds them. Nothing is cached: the facade keeps the
    plan of its model in memory."""
    rfilter = ops.setup_filter(list(cfg.resample_filter))
    plan = {"blocks": {}, "min_channels": min_channels}
    for res in cfg.block_resolutions:
        co = cfg.channels(res)
        if res == 4 or co >= min_channels:
            continue
        block = params["synthesis"][f"b{res}"]
        entry = {}
        # conv0: transposed conv up 2 and the FIR, from the res/2 grid (a pixel a cell) to 2x2 cells
        w0 = _hwio(block["conv0"]["weight"])
        entry["k0"] = _extract_conv_kernel(lambda x, w: _np_conv2d_resample_up2(x, w, rfilter, padding=1),
                                           w0, in_cell=1, out_cell=2)
        # conv1: the 3x3 conv at res, cells to cells
        w1 = _hwio(block["conv1"]["weight"])
        entry["k1"] = _extract_conv_kernel(lambda x, w: _np_corr(x, w, pads=((1, 1), (1, 1))), w1, 2, 2)
        if "torgb" in block:
            entry["kt"] = _extract_conv_kernel(_np_corr, _hwio(block["torgb"]["weight"]), 2, 2)
        # the image's upsample FIR: the res/2 image (a pixel a cell) to 2x2 cells
        entry["kimg"] = _extract_kernel(lambda x: _np_upsample2d(x, rfilter), cfg.img_channels, in_cell=1, out_cell=2)
        # sums of w^2 over the taps for the demodulation, (ci, co)
        entry["w0_sq"] = np.sum(w0**2, axis=(0, 1))
        entry["w1_sq"] = np.sum(w1**2, axis=(0, 1))
        plan["blocks"][res] = entry
    return plan


def _quantize_act(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """Per-channel symmetric int8 quantization of x (B, C, H, W) with calibrated amax (C,): clip(round(x *
    127 / amax), -127, 127), the scale in f32, ties to even."""
    s = 127.0 / amax.float()
    return torch.round(x.float() * s[None, :, None, None]).clamp_(-127.0, 127.0).to(torch.int8)


def quantize_plan(params: Dict, plan: Dict, cfg: SG2Config, ws: Optional[torch.Tensor] = None, batch: int = 8,
                  seed: int = 0, margin: float = 1.05) -> Dict:
    """Calibrate and quantize the s2d tail's cell convs to int8 (opt-in, W8A8).

    The amax of each quantized conv's input, per channel, is recorded over
    one float synthesis of `ws` (by default `batch` mapped latents) with
    random noise, times `margin`; each kernel takes the activation dequant
    (a / 127 per input channel) and is quantized per output channel. Mutates
    and returns `plan` (maua_tpu's numpy layout) with q0, s0, a0, q1, s1, a1 per
    block, which `device_plan` carries to a device; `synthesis_fast` then runs
    the quantized branch. An already quantized plan is recalibrated.

    Two departures follow from the random number generators, so a plan
    calibrated here differs from maua_tpu's on the same net: with ws=None the
    latents (and the one-hot labels of a conditional net) come from a
    torch.Generator seeded with `seed` on the parameters' device, where
    maua_tpu uses jax.random; the calibration's random noise comes from one
    seeded with seed + 1. Given the same ws and zero noise strengths, the two
    plans agree."""
    if not plan["blocks"]:
        return plan
    for entry in plan["blocks"].values():  # recalibration: the calibration takes the float path
        for k in _QUANT_KEYS:
            entry.pop(k, None)
    device = params["synthesis"]["b4"]["const"].device
    with torch.no_grad():
        if ws is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            z = torch.randn(batch, cfg.z_dim, generator=gen, device=device)
            c = None
            if cfg.c_dim > 0:  # a conditional net: calibrate over random one-hot labels
                labels = torch.randint(0, cfg.c_dim, (batch,), generator=gen, device=device)
                c = F.one_hot(labels, cfg.c_dim).float()
            ws = mapping(params, z, cfg, c)
        tape: Dict = {}
        synthesis_fast(params, device_plan(plan, cfg, device), ws, cfg, noise_mode="random",
                       gen=torch.Generator(device=device).manual_seed(seed + 1), _amax_tape=tape)
    for res, entry in plan["blocks"].items():
        a0 = np.maximum(tape[f"{res}.a0"].cpu().numpy().astype(np.float32) * margin, 1e-6)
        a1 = np.maximum(tape[f"{res}.a1"].cpu().numpy().astype(np.float32) * margin, 1e-6)
        for kname, a, sk, qk in (("k0", a0, "s0", "q0"), ("k1", a1, "s1", "q1")):
            # the activation dequant (a / 127 per input channel) folds into the weight, quantized per output
            # channel
            w = entry[kname] * (a / 127.0)[None, None, :, None]
            s = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12).astype(np.float32)
            entry[qk] = np.clip(np.round(w / s), -127, 127).astype(np.int8)
            entry[sk] = s
        entry["a0"], entry["a1"] = a0, a1
    return plan


def device_plan(plan: Dict, cfg: SG2Config, device) -> Dict:
    """A plan of `build_fast_plan` (or `quantize_plan`) as `synthesis_fast` takes it: its kernels as OIHW
    tensors on `device`, each block's convs in its compute dtype and the image kernel in f32, its int8 kernels
    q0 and q1 as int8, and its demodulation sums and quantization scales as f32 tensors. A maua_tpu plan
    (numpy, HWIO) converts the same way."""
    f32_keys = ("kimg", "w0_sq", "w1_sq", "s0", "s1", "a0", "a1")

    def convert(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        return t.to(device=device, dtype=dtype).contiguous()

    blocks = {}
    for res, e in plan["blocks"].items():
        dtype = cfg.compute_dtype(res)
        blocks[res] = {k: convert(a, torch.int8 if k in ("q0", "q1") else torch.float32 if k in f32_keys else dtype)
                       for k, a in e.items()}
    return {**plan, "blocks": blocks}


def _conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Same-size correlation with an OIHW cell kernel (an even kernel pads one more before than after)."""
    kh, kw = k.shape[2], k.shape[3]
    if kh % 2 and kw % 2:
        return F.conv2d(x, k, padding=(kh // 2, kw // 2))
    return F.conv2d(F.pad(x, [kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2]), k)


def _cell_noise(p, name, res, batch, noise_mode, noises, gen, dtype, device):
    """A layer's noise in cell layout, (B|1, 4, res/2, res/2): one group
    per phase for the epilogue. Random noise is drawn in that shape (iid,
    so it has the distribution of the full-resolution draw); given and
    const noise maps are repacked exactly."""
    if noise_mode == "none":
        return None
    strength = p.get("noise_strength", torch.ones((), device=device))
    if noises is not None and name in noises:
        n = layer_noise_input(noises[name]) * strength
        return space_to_depth(n).to(dtype)
    if noise_mode == "random":
        n = torch.randn(batch, 4, res // 2, res // 2, generator=gen, device=device, dtype=dtype)
        return n * strength.to(dtype)
    return space_to_depth((p["noise_const"] * strength)[None, None]).to(dtype)


def motion_layer_bound(plan: Dict, cfg: SG2Config) -> int:
    """The first per-conv layer index inside the s2d tail: motion at a
    lower index runs in the plain head, so the route can take it (the
    facade's dispatch)."""
    li = 2
    for res in cfg.block_resolutions[1:]:
        if res in plan["blocks"]:
            return li
        li += 2
    return li


def synthesis_fast(
    params: Dict,
    plan: Dict,
    ws: torch.Tensor,
    cfg: SG2Config,
    noise_mode: str = "random",
    noises: Optional[Dict] = None,
    gen: Optional[torch.Generator] = None,
    translation: Optional[torch.Tensor] = None,
    zoom: Optional[torch.Tensor] = None,
    rotation: Optional[torch.Tensor] = None,
    rcfg=None,
    _amax_tape: Optional[Dict] = None,
) -> torch.Tensor:
    """The synthesis of `stylegan2.synthesis` with the plan's blocks on
    s2d grids: ws (B, num_ws, w_dim) -> image (B, C, H, W) in f32.

    `plan` is a `device_plan` on ws's device. Translation, zoom and
    rotation apply at `rcfg`'s layers, which must lie below
    `motion_layer_bound` (in the plain head); random noise is drawn from
    `gen` (seed 0 when None). A quantized plan (`quantize_plan`) runs its
    blocks' cell convs in int8. `_amax_tape` is the calibration's hook: a
    dict given there receives the per-channel |max| of each quantizable conv
    input on the float path."""
    from .wrappers import RenderConfig, apply_motion

    if cfg.architecture == "resnet":
        raise ValueError("the s2d route has no resnet skip branch; use stylegan2.synthesis")
    rcfg = rcfg or RenderConfig()
    syn = params["synthesis"]
    rfilter = ops.setup_filter(list(cfg.resample_filter))
    batch, device = ws.shape[0], ws.device
    clamp = float(cfg.conv_clamp) if cfg.conv_clamp is not None else None
    if noise_mode == "random" and gen is None:
        gen = torch.Generator(device=device).manual_seed(0)

    def motion(x, idx):
        return apply_motion(x, idx, rcfg, translation, zoom, rotation)

    li = 1
    x = img = None  # x and img are in cell layout once s2d_mode is on
    w_idx = 0
    s2d_mode = False
    for res in cfg.block_resolutions:
        block = syn[f"b{res}"]
        dtype = cfg.compute_dtype(res)
        num_conv = cfg.block_num_conv(res)
        block_ws = ws[:, w_idx : w_idx + num_conv + 1]

        if res not in plan["blocks"]:
            def noise(name):
                return _layer_noise(block[name], f"b{res}.{name}", res, batch, noise_mode, noises, gen, device)

            if res == 4:
                x = block["const"][None].to(dtype).repeat(batch, 1, 1, 1)
                x = motion(synthesis_layer(block["conv1"], x, block_ws[:, 0], 1, rfilter, cfg, noise("conv1")), 0)
                li = 2
            else:
                x = x.to(dtype)
                for ci, cname in enumerate(("conv0", "conv1")):
                    x = synthesis_layer(block[cname], x, block_ws[:, ci], 2 - ci, rfilter, cfg, noise(cname))
                    x = motion(x, li)
                    li += 1
            if img is not None:
                img = ops.upsample2d(img, rfilter)
            if res == cfg.img_resolution or cfg.architecture == "skip":
                y = torgb_layer(block["torgb"], x, block_ws[:, num_conv], cfg)
                img = img + y.to(img.dtype) if img is not None else y.float()
            w_idx += num_conv
            continue

        entry = plan["blocks"][res]
        co = cfg.channels(res)
        p0, p1 = block["conv0"], block["conv1"]
        if s2d_mode:
            x = depth_to_space(x)  # a chained s2d block hands its cells on at full resolution

        # conv0 (up): from the res/2 grid to cells; its epilogue also applies conv1's input style
        styles0 = fc_forward(p0["affine"], block_ws[:, 0].float())
        x_in = x.to(dtype) * styles0.to(dtype)[:, :, None, None]
        if _amax_tape is not None:
            _amax_tape[f"{res}.a0"] = x_in.float().abs().amax(dim=(0, 2, 3))
        d0 = torch.rsqrt(styles0.square() @ entry["w0_sq"] + 1e-8)
        styles1 = fc_forward(p1["affine"], block_ws[:, 1].float())
        d1 = torch.rsqrt(styles1.square() @ entry["w1_sq"] + 1e-8)
        # the epilogue on cells: demod and bias tiled 4x, the noise as 4 phase groups; conv0's also applies
        # conv1's input style (pre_next)
        n0 = _cell_noise(p0, f"b{res}.conv0", res, batch, noise_mode, noises, gen, dtype, device)
        if "q0" in entry:
            # int8 cell convs: each dequant scale (per output channel) folds into its demod, and conv1's
            # quantization (127 / a1) into pre_next, so conv0's epilogue writes conv1's int8 operand
            y = conv_i8(_quantize_act(x_in, entry["a0"]), entry["q0"])
            y = modconv_epilogue(y, d0.repeat(1, 4) * entry["s0"][None], n0, p0["bias"].repeat(4), clamp=clamp,
                                 pre_next=styles1.repeat(1, 4) * (127.0 / entry["a1"])[None], quant_out=True)
            n1 = _cell_noise(p1, f"b{res}.conv1", res, batch, noise_mode, noises, gen, torch.float32, device)
            x = modconv_epilogue(conv_i8(y, entry["q1"]), d1.repeat(1, 4) * entry["s1"][None], n1,
                                 p1["bias"].repeat(4), clamp=clamp).to(dtype)
        else:
            y = modconv_epilogue(_conv(x_in, entry["k0"]), d0.repeat(1, 4), n0, p0["bias"].repeat(4), clamp=clamp,
                                 pre_next=styles1.repeat(1, 4))
            if _amax_tape is not None:
                _amax_tape[f"{res}.a1"] = y.float().abs().amax(dim=(0, 2, 3))
            # conv1 (same size): cells to cells
            n1 = _cell_noise(p1, f"b{res}.conv1", res, batch, noise_mode, noises, gen, dtype, device)
            x = modconv_epilogue(_conv(y, entry["k1"]), d1.repeat(1, 4), n1, p1["bias"].repeat(4), clamp=clamp)

        if img is not None:
            if s2d_mode:
                img = depth_to_space(img)
            img = _conv(img.float(), entry["kimg"])  # upsampled into this block's cells
        if res == cfg.img_resolution or cfg.architecture == "skip":
            pt = block["torgb"]
            k = pt["weight"].shape[-1]
            stylest = fc_forward(pt["affine"], block_ws[:, num_conv].float()) * (1.0 / math.sqrt(co * k * k))
            yt = _conv(x * stylest.repeat(1, 4).to(dtype)[:, :, None, None], entry["kt"])
            yt = ops.bias_act(yt, pt["bias"].repeat(4).to(dtype), clamp=cfg.conv_clamp)
            img = img + yt.float() if img is not None else yt.float()
        s2d_mode = True
        w_idx += num_conv

    if s2d_mode:
        img = depth_to_space(img)
    return img.float()


def make_fast_synthesis(params: Dict, cfg: SG2Config, min_channels: int = 128, int8: bool = False):
    """Build the plan and return (synthesis closure, plan): the closure maps
    ws and `synthesis_fast`'s keywords to images, with the plan's kernels
    converted once to the device of the parameters. int8=True also
    calibrates and quantizes the tail's convs (`quantize_plan`): int8 W8A8
    cell convs, no longer exact (their speed on the card: PERF.md, Findings)."""
    plan = build_fast_plan(params, cfg, min_channels)
    if int8:
        plan = quantize_plan(params, plan, cfg)
    dplan = device_plan(plan, cfg, params["synthesis"]["b4"]["const"].device)
    return (lambda ws, **kw: synthesis_fast(params, dplan, ws, cfg, **kw)), plan

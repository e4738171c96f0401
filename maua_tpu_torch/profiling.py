"""Per-stage timing, torch.profiler traces, FLOP counts and model-FLOPs utilization.

Port of `maua_tpu/profiling.py`: `StageTimer` synchronizes the card
(`torch.cuda.synchronize`) where maua_tpu waits on JAX's effects, `trace`
records a torch.profiler Chrome trace, `annotate` names a region in it,
`compiled_flops` counts one call's FLOPs with
`torch.utils.flop_counter.FlopCounterMode`, and `mfu` divides by the
card's peak. The analytic counts (`sg2_frame_flops`, `unet_step_flops`,
`sg3_frame_flops`, `rrdb_flops`, `d2_forward_flops`,
`gan_train_step_flops`) are maua_tpu's over the port's config classes.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    """Accumulating wall-clock stage timer; with `sync`, each stage ends by waiting for the card's queued
    work (when there is a card), so a stage owns its device time."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                          total(s)   calls   mean(ms)"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30} {total:8.3f} {n:7d} {1000 * total / n:10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "maua_trace")):
    """torch.profiler over the block (the host, and the card where there is one); the Chrome trace is written
    to `log_dir/trace.json` on exit (open it in Perfetto or chrome://tracing). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region inside a trace."""
    return torch.profiler.record_function(name)


# ------------------------------------------------------------------ MFU
# NVIDIA H100 SXM peaks from its data sheet, dense (no sparsity), in TFLOP/s (int8: TOPS): bf16 and fp16 on the
# tensor cores, tf32 on the tensor cores, f32 on the CUDA cores. A card whose power limit is set below 700 W
# runs below them under load: report its name and limit (nvidia-smi) beside any utilization.
H100_PEAK_TFLOPS = {"bfloat16": 989.0, "float16": 989.0, "tf32": 495.0, "float32": 67.0, "int8": 1979.0}


def compiled_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of one call of `fn(*args, **kwargs)` as torch's FlopCounterMode counts them (the matmuls and
    convolutions the call dispatches, 2 per multiply-add): the work actually launched, so padding shows up;
    pair it with an analytic model count."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(model_flops: float, seconds: float, dtype: str = "bfloat16") -> float:
    """Model-FLOPs utilization: achieved FLOP/s over the card's peak for `dtype` (bf16's for a dtype not in
    H100_PEAK_TFLOPS)."""
    peak = H100_PEAK_TFLOPS.get(dtype, H100_PEAK_TFLOPS["bfloat16"])
    return (model_flops / seconds) / (peak * 1e12)


def sg2_frame_flops(cfg) -> float:
    """Analytic model FLOPs for one StyleGAN2 synthesis frame (the modulated convs and toRGB; the mapping and
    the FIR resampling are noise): 2 * H * W * Cin * Cout * k^2 per conv at its output resolution."""
    total = 0.0
    for res in cfg.block_resolutions:
        co = cfg.channels(res)
        if res == 4:
            total += 2 * res * res * co * co * 9  # conv1
        else:
            ci = cfg.channels(res // 2)
            total += 2 * res * res * ci * co * 9  # conv0 (up)
            total += 2 * res * res * co * co * 9  # conv1
        total += 2 * res * res * co * cfg.img_channels  # torgb 1x1
    return total


def unet_step_flops(cfg, hw: int, context_len: int = 77) -> float:
    """Analytic model FLOPs for one SD-class UNet evaluation on an hw x hw latent (the resblocks' 3x3 convs,
    attention projections and matmuls, the GEGLU feed-forward), approximate to ~10 %."""
    total = 0.0
    chans = [cfg.model_channels * m for m in cfg.channel_mult]
    # resblock convs at each level, down, up and skips: about 3x the encoder's count
    for lvl, c in enumerate(chans):
        size = hw // (2 ** lvl)
        n_blocks = cfg.num_res_blocks * 3
        total += n_blocks * 2 * (size * size) * c * c * 9 * 2  # two convs a block
        if (2 ** lvl) in cfg.attention_resolutions:
            n = size * size
            d = c
            per_tx = (
                4 * 2 * n * d * d  # self qkv + proj
                + 2 * 2 * n * n * d  # qk^T + av
                + 2 * 2 * n * d * d  # cross q + proj
                + 2 * 2 * context_len * d * d  # cross kv
                + 2 * 2 * n * context_len * d  # cross attention matmuls
                + 2 * n * d * (8 * d) * 2  # geglu ffn
            )
            total += n_blocks * per_tx * cfg.transformer_depth
    return total


def sg3_frame_flops(cfg) -> float:
    """Analytic model FLOPs for one StyleGAN3 frame: the modulated convs at each layer's input canvas (the
    filtered lrelu's FIR chain is bound by bytes, not FLOPs, and is left out)."""
    _, _, _, _, sizes, chans = cfg.layer_plan()
    k = cfg.conv_kernel
    total = 2 * int(sizes[0]) ** 2 * cfg.channel_max * int(chans[0])  # input 1x1 mix
    for i in range(1, len(chans)):
        ci, co = int(chans[i - 1]), int(chans[i])
        kk = 1 if i == len(chans) - 1 else k  # torgb is 1x1
        total += 2 * int(sizes[i - 1]) ** 2 * ci * co * kk * kk
    return float(total)


def rrdb_flops(cfg, h: int, w: int) -> float:
    """Analytic model FLOPs for one RRDBNet forward on an (h, w) input (dense blocks, trunk, the nearest
    upsample convs; RealESRGAN x4)."""
    nf, gc, nb = cfg.num_feat, cfg.num_grow_ch, cfg.num_block
    hw = h * w
    total = 2 * hw * cfg.num_in_ch * nf * 9  # conv_first
    per_db = sum(2 * hw * (nf + k * gc) * (gc if k < 4 else nf) * 9 for k in range(5))
    total += nb * 3 * per_db  # 3 dense blocks an RRDB
    total += 2 * hw * nf * nf * 9  # trunk conv
    s = 1
    while s < cfg.scale:  # the upsample convs run at the upsampled size
        s *= 2
        total += 2 * (h * s) * (w * s) * nf * nf * 9
    total += 2 * (h * cfg.scale) * (w * cfg.scale) * nf * nf * 9  # conv_hr
    total += 2 * (h * cfg.scale) * (w * cfg.scale) * nf * cfg.num_out_ch * 9  # conv_last
    return float(total)


def d2_forward_flops(cfg) -> float:
    """Analytic model FLOPs for one discriminator forward (resnet D: two 3x3 convs and a 1x1 skip a block at
    the block's input size)."""
    total = 2 * cfg.img_resolution**2 * cfg.img_channels * cfg.channels(cfg.img_resolution)  # frgb 1x1
    for res in cfg.block_resolutions:
        ci, co = cfg.channels(res), cfg.channels(res // 2)
        total += 2 * res * res * ci * ci * 9  # conv0 (same)
        total += 2 * (res // 2) ** 2 * ci * co * 9  # conv1 (down)
        total += 2 * (res // 2) ** 2 * ci * co  # skip 1x1
    c4 = cfg.channels(4)
    total += 2 * 16 * (c4 + cfg.mbstd_num_channels) * c4 * 9  # final conv
    total += 2 * 16 * c4 * c4  # fc
    return float(total)


def gan_train_step_flops(g_cfg, d_cfg, batch: int) -> float:
    """Approximate model FLOPs for one alternating D + G train step of `batch` images (a backward counted as
    twice the forward): the D step is G forward (no grad) and D forward + backward on fakes and reals, the G
    step G and D forward + backward. The lazy R1 and path-length steps are left out."""
    g = sg2_frame_flops(g_cfg)
    d = d2_forward_flops(d_cfg)
    per_image = (1 * g + 3 * d + 3 * d) + (3 * g + 3 * d)
    return float(per_image * batch)

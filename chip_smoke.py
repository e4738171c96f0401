#!/usr/bin/env python3
"""Drive the PyTorch port (maua_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc builds every CUDA kernel of the paths from the sources
   under maua_tpu_torch/csrc into maua_tpu_torch/_build, all at once.
3. kernel: the modulated-conv epilogue kernel against its plain PyTorch
   version at every epilogue shape of a 1024^2 StyleGAN2 frame batch of
   8, in each layer's dtype, plus its option cases at one shape; CUDA
   event times beside the memory-bytes bound and the plain version.
4. flrelu: the filtered-lrelu kernel against its plain PyTorch version
   at the 13 shapes of a 1024^2 StyleGAN3 frame batch, in bf16 at batch
   8 with the affines and the centre crops synthesis passes and in f32 at
   batch 1, plus its option cases; CUDA event times beside the bound (of
   the kept outputs) and the plain version.
5. e2e: the audio-reactive video (ExampleSG2Patch, memmap renderer) of a
   3 s synthetic wav made from a seed, at 24 fps, through a random-init
   full-width StyleGAN2 (config-f, 1024^2, bf16 top resolutions), with
   the epilogue's launch count reset just before and read just after.
6. sg3_e2e: the same wav through ExampleSG3Patch and a random-init
   full-width StyleGAN3 (config T, 1024^2, bf16 trunk), with the
   filtered-lrelu launch count reset just before and read just after.
7. profile, sg3_profile: one render batch of each net under
   torch.profiler, device time by kernel and the device's idle share.
8. reference, sg3_reference: one frame of each net in f32 with TF32 off,
   on the card with the kernels and on the CPU with the plain versions,
   PSNR (StyleGAN3 at 256^2, to bound the CPU's time).
9. attn (after flrelu): the flash-attention kernel against its plain
   version at the shapes and layouts of a 512^2 Stable Diffusion image
   and two odd cases (one with peaked scores), in f32 and bf16, with CUDA
   event times beside the bound, the plain version and
   F.scaled_dot_product_attention (timed as a yardstick only).
10. sd_e2e: text to image through `image_sample` at 512^2, 50 LMS steps,
   cfg 5.0, random-init full-width SD 1.x in f32, with the attention
   kernel's launch count reset just before and read just after (501).
11. sd_steps, sd_profile: CFG denoiser steps/s at 512^2 with a bf16 UNet
   (bench_diffusion.py's metric), and one step of each dtype under
   torch.profiler.
12. sd_reference: the same random SD on the card and on the CPU, f32 with
   TF32 off, 256^2, 2 LMS steps and a decode, image PSNR.
13. mel (after attn): the mel-spectrogram kernel against its plain version
   at n_fft 2048, hop 512 with 128 mels and hop 1024 with 512 mels, on 3 s
   and 180 s signals and a batch of 4; CUDA event times beside the bound,
   the plain version and torch.stft + the mel matmul (a yardstick only).
14. kconv: the 3x3 conv kernel against its plain version at the last three
   3x3 layers of a 1024^2 StyleGAN3 and RRDB's growth convs at 512^2, bf16
   at batch 8 and f32 at batch 1; times beside the bound, the plain
   version and cuDNN's F.conv2d. No path calls it.
15. ar_e2e (after sg3_e2e): the mel-bearing patch (MEL_PATCH_BODY: librosa
   onsets, tempo, pulse, segmentation, volume, STFT chroma) over the 3 s
   wav through the full-width StyleGAN2, the epilogue's and the mel
   kernel's launch counts reset just before and read just after.
16. ar_features: a 180 s synthetic song (seed 1, chords changing every 8 s)
   through every feature of that patch on the card in a fresh process,
   per-feature seconds cold and warm, and the mel launches with the
   MEL_SHAPES case of each (the record prices the song's launches by them).
17. ar_reference: the song's first 20 s through the features on the card
   and on the CPU, f32 with TF32 off: envelope errors, tempo, boundaries.
18. gan_load (after ar_reference): full-width StyleGAN2 and StyleGAN3
   generators from seed 0 written as an NVIDIA ADA .pkl, a rosinality .pt
   and an NVIDIA-named StyleGAN3 .pt, loaded with load_network (every
   tensor equal to its source), and the e2e clip rendered from the .pkl
   and from the StyleGAN3 .pt through the entry point's model_file, the
   same bytes as from the source passed as params.
19. sd_load: a full-width SD 1.x CompVis checkpoint in fp16 from seed 0,
   loaded with load_stable_diffusion (every tensor equal to the fp16
   source), and one 512^2 10-step image from it and from the source trees:
   PSNR >= 60 dB.
20. writer: the FFMPEG renderer end to end (24 frames at 1024^2) through
   ffmpeg or, without it, OpenCV; the file read back with OpenCV.
21. delivery (last of all): render fps by delivery route (the synchronous pageable
   copy against pipelined_frames, rgb24 and yuv420p) for StyleGAN2 and
   StyleGAN3 at 1024^2, batch 8 and 32, in one call, with each route's
   idle share, the copy times pinned and pageable, and rgb_to_yuv420 on
   the card against the CPU.
22. super_load (after writer): a basicsr .pth of RealESRGAN-x4plus, an
   SRVGG .pth, an official SwinIR-M .pth and a waifu2x .json written from
   seed-1 weights into a temporary MODELZOO, loaded by the Upscaler (every
   tensor equal to its source) and upscaling to the source's bytes.
23. super_video: a synthetic 24-frame 256^2 clip upscaled with
   RealESRGAN-x4plus and interpolated with RIFE at factors 2 and 4
   through the video entry points and this machine's writer, read back.
24. super (after sd_reference): RealESRGAN-x4plus through the Upscaler, 8
   frames 256^2 -> 1024^2, img/s in f32 (cuDNN TF32) and bf16, peak
   memory, one profiled batch, beside the operations bound; then each
   registry kind once at full width on a small input.
25. super_reference: every registry kind but latent-diffusion on the card
   and on the CPU, f32 with TF32 off, 64^2 input, PSNR.
26. sd_multires: image_sample at 512^2 -> RealESRGAN-x4plus -> lanczos to
   1024^2 -> nine 512^2 tiles in batches of 4, 4 and 1 from t 0.5 (20 LMS
   steps, SD 1.x f32, seed 0), with the attention kernel's launch count
   reset just before and read just after (507).
Phases that upscale fail if an out-of-memory ladder took a rung past its
first.

`--phases a,b` runs only the named phases after device and build (for
iterating on one kernel); with no arguments every phase runs. Any
failure exits non-zero. It needs one CUDA card and writes only to a
temporary directory and to the kernel build directory. The last two
lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM tf32 tensor cores, dense
FPS = 24
SECONDS = 3.0
SR = 22050
BATCH = 8
SONG_SECONDS = 180.0  # the ar_features song
# card vs CPU, envelopes in [0, 1]: the card's FFTs (cuFFT, the mel kernel) and
# the CPU's round differently (measured <= 1.2e-6 on an H100), and the
# percentile clip's peak pick can turn a near-tie either way
AR_REFERENCE_TOL = 1e-3


# The mel-bearing patch that ar_e2e renders: librosa-style onsets, tempo and
# pulse, laplacian segmentation, volume and STFT chroma drive tempo loops and
# envelope-weighted latents. The body is plain Python over the `ar` API, so
# tests/test_torch_slice.py also runs it through maua_tpu, with its own header.
MEL_PATCH_HEADER = """
import numpy as np
import torch

from maua_tpu_torch.audiovisual import audioreactive as ar
from maua_tpu_torch.audiovisual.patches import primitives
from maua_tpu_torch.audiovisual.patches.base import StyleGAN2Patch


def asarray(a, like):
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)
"""
MEL_PATCH_BODY = """
SECTIONS = 3


class MelPatch(StyleGAN2Patch):
    def process_audio(self):
        n = self.n_frames
        self.onsets = ar.onsets(self.audio, self.sr, n, margin=2, smooth=2, type="rosa")
        self.pulse = ar.pulse(self.audio, self.sr, n, type="rosa").reshape(-1, 1, 1)
        self.volume = ar.volume(self.audio, self.sr, n, smooth=2).reshape(-1, 1, 1)
        self.chroma = ar.chroma(self.audio, self.sr, n, margin=2, type="stft")
        self.tempo = ar.tempo(self.audio, self.sr, type="rosa")[0]
        times, labels = ar.laplacian_segmentation(self.audio, self.sr, k=SECTIONS)
        section = labels[np.searchsorted(times, np.arange(n) / self.fps, side="right") - 1]
        self.sections = asarray(np.eye(SECTIONS, dtype=np.float32)[section], self.chroma)

    def process_mapper_inputs(self):
        return {"z": self.stylegan2.get_z_latents("0-19")}

    def process_synthesizer_inputs(self, latent_w):
        n = self.n_frames
        loops = ar.tempo_loops(latent_w[:4], n, self.fps, self.tempo)
        bar = primitives.tempo_loop_latents(self.tempo, latent_w[4:8], 1, self.fps)
        bar = bar[np.arange(n) % bar.shape[0]]
        sections = ar.multi_weighted(latent_w[8 : 8 + SECTIONS], self.sections)
        tonal = ar.multi_weighted(latent_w[7:19], self.chroma)
        w = 0.5 * loops + 0.5 * sections
        w = (1 - 0.5 * self.volume) * w + 0.5 * self.volume * tonal
        w = (1 - 0.5 * self.pulse) * w + 0.5 * self.pulse * bar
        kick = ar.single_weighted(latent_w[0], latent_w[18], self.onsets) - latent_w[0]
        return {"latent_w_plus": w + 0.5 * kick}
"""


def phase(name, fn):
    t0 = time.perf_counter()
    out = fn()
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **(out or {})}), flush=True)
    return out


def synth_wav(path: str, seconds: float = SECONDS, sr: int = SR, seed: int = 0, chords: bool = False) -> None:
    """A kick / snare / bass / tone mix, made from a seed; with `chords`, a
    progression of four chords that changes every 8 s over it (a song with
    sections to segment)."""
    import numpy as np
    from scipy.io import wavfile

    rs = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    y = 0.25 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 0.5 * t))
    y += 0.15 * np.sin(2 * np.pi * 220 * 1.5 * t)
    y += 0.3 * np.sin(2 * np.pi * 55 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 1.0 * t))
    n = int(0.12 * sr)
    env = np.exp(-np.arange(n) / (0.025 * sr))
    for beat in np.arange(0, seconds, 0.5):
        i = int(beat * sr)
        kick = np.sin(2 * np.pi * (50 + 80 * env) * np.arange(n) / sr) * env
        y[i : i + n] += 0.9 * kick[: len(y) - i]
        j = int((beat + 0.25) * sr)
        if j + n <= len(y):
            y[j : j + n] += 0.4 * rs.randn(n) * env
    if chords:
        progression = ([220.0, 277.18, 329.63], [174.61, 220.0, 261.63], [196.0, 246.94, 293.66],
                       [164.81, 207.65, 246.94])
        for s in range(int(np.ceil(seconds / 8))):
            part = slice(int(8 * s * sr), int(8 * (s + 1) * sr))
            y[part] += sum(0.12 * np.sin(2 * np.pi * f * t[part]) for f in progression[s % 4])
    wavfile.write(path, sr, (y / np.abs(y).max() * 0.9).astype(np.float32))


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# cuda_time_ms times back-to-back calls over at least this many ms: shorter windows of short kernels read
# clock ramps and launch jitter
TIME_WINDOW_MS = 20.0


def cuda_time_ms(fn, iters: int = 20) -> float:
    """Mean ms per call over back-to-back calls after 3 warm-ups: at least `iters` calls, more where those
    take under TIME_WINDOW_MS."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    while True:
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if ms >= TIME_WINDOW_MS or iters >= 10000:
            return ms / iters
        iters = min(10000, math.ceil(iters * 1.2 * TIME_WINDOW_MS / max(ms, 1e-3)))


def kernel_device_ms(fn, marker: str, calls: int = 20) -> float:
    """Device time per call of the kernels whose name holds `marker`, over `calls` calls of fn under
    torch.profiler (after one warm call): a kernel's own time, where cuda_time_ms reads its caller's host
    time instead (a launch shorter than the wrapper's Python)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and marker in e.key) / calls / 1e3


def epilogue_cases():
    """(label, B, C, H, W, dtype, noise batch or 0, groups, pre_next, clamp) of
    every epilogue launch of one 1024^2 frame batch, then the option cases."""
    import torch

    from maua_tpu_torch.gan.stylegan2 import SG2Config

    cfg = SG2Config(dtype="bfloat16")
    cases = []
    for res in cfg.block_resolutions:
        # the example patch gives per-frame noise to b4..b64 and the rest keep noise_const
        nb = BATCH if res <= 64 else 1
        cases.append((f"b{res}", BATCH, cfg.channels(res), res, res, cfg.compute_dtype(res), nb, 1, False, 256.0))
    for label, nb, g, pre, clamp in [("no-noise", 0, 1, False, 256.0), ("shared-noise", 1, 1, False, 256.0),
                                     ("groups-8", BATCH, 8, False, 256.0), ("pre-next", BATCH, 1, True, 256.0),
                                     ("clamp-none", BATCH, 1, False, None)]:
        cases.append((label, BATCH, 128, 256, 256, torch.bfloat16, nb, g, pre, clamp))
    cases.append(("f32-groups-4", BATCH, 512, 32, 32, torch.float32, BATCH, 4, True, 256.0))
    return cfg, cases


def check_epilogue():
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    cfg, cases = epilogue_cases()
    num_conv = {res: cfg.block_num_conv(res) for res in cfg.block_resolutions}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, batch_ms, batch_plain_ms, batch_bound_ms = [], 0.0, 0.0, 0.0
    worst = 0.0
    for label, b, c, h, w, dtype, nb, g, pre, clamp in cases:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        z = (rnd(b, c, h, w) * 4).to(dtype)
        post = rnd(b, c).abs() + 0.1
        noise = rnd(nb, g, h, w) if nb else None
        bias = rnd(c) * 0.1
        pre_next = rnd(b, c).abs() + 0.5 if pre else None
        args = (z, post, noise, bias, 0.2, math.sqrt(2.0), clamp, pre_next)
        out = E.modconv_epilogue(*args)
        ref = E.modconv_epilogue_plain(*args)
        torch.cuda.synchronize()
        # both sides compute in f32 and round once; bf16 storage allows one bf16 ulp
        rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
        diff = (out.float() - ref.float()).abs()
        ok = bool((diff <= rtol * ref.float().abs() + 1e-6).all())
        err = float(diff.max())
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"epilogue {label} disagrees with its plain version: max abs err {err}")
        nbytes = 2 * z.numel() * z.element_size() + (noise.numel() * 4 if noise is not None else 0) \
            + 4 * (post.numel() + bias.numel() + (pre_next.numel() if pre else 0))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 8 * z.numel() / F32_FLOPS) * 1e3
        ms = cuda_time_ms(lambda: E.modconv_epilogue(*args))
        plain_ms = cuda_time_ms(lambda: E.modconv_epilogue_plain(*args))
        rows.append({"case": label, "shape": [b, c, h, w], "dtype": str(dtype).split(".")[-1],
                     "noise": None if not nb else [nb, g], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": nbytes})
        if label.startswith("b") and label[1:].isdigit():
            reps = num_conv[int(label[1:])]
            batch_ms += reps * ms
            batch_plain_ms += reps * plain_ms
            batch_bound_ms += reps * bound_ms
    E.reset_launches()  # the comparison launches do not count
    for r in rows:
        print(json.dumps({"epilogue": r}), flush=True)
    return {"max_abs_err": worst, "frame_batch_ms": batch_ms, "frame_batch_plain_ms": batch_plain_ms,
            "frame_batch_bound_ms": batch_bound_ms}


def flrelu_macs(b: int, c: int, h: int, w: int, up: int, crop=None) -> int:
    """Multiply-adds of the direct separable polyphase form for one call:
    up-FIR along H (6 per tmp row sample at the input width), along W (6
    per tmp sample), down-FIR along W (12 per sample at the output width)
    and along H (12 per output sample); with a `crop` window, the share of
    them that its kept outputs take."""
    ht, wt, ho, wo = h * up, w * up, h * up // 2, w * up // 2
    macs = b * c * (ht * w * 6 + ht * wt * 6 + ht * wo * 12 + ho * wo * 12)
    return macs if crop is None else macs * crop[2] * crop[3] // (ho * wo)


def flrelu_call(FL, x, up_f, down_f, up, crop, kw, plain=False):
    """One filtered lrelu as StyleGAN3's synthesis makes it: the kept window
    of the output, contiguous."""
    fn = FL.filtered_lrelu_plain if plain else FL.filtered_lrelu
    return fn(x, up_f, down_f, up, 2, crop=crop, **kw)


def flrelu_cases():
    """(label, B, C, H, W, up, up_f, down_f, dtype, pre, post, crop) of the
    13 filtered-lrelu launches of one 1024^2 StyleGAN3 frame batch in bf16
    at batch 8 (each with the centre crop to the next canvas that the
    synthesis asks of it), the same 13 in f32 at batch 1, then the option
    cases."""
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config, resample_plan

    cfg = SG3Config(dtype="bfloat16")
    _, _, _, _, sizes, channels = cfg.layer_plan()
    plan = resample_plan(cfg)
    cases = []
    for dtype, b in ((torch.bfloat16, BATCH), (torch.float32, 1)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for i, (up, _, up_f, down_f, out_size) in enumerate(plan):
            s = int(sizes[i])
            full = s * up // 2
            o = (full - out_size) // 2
            crop = (o, o, out_size, out_size) if full > out_size else None
            cases.append((f"L{i}-{tag}", b, int(channels[i + 1]), s, s, up, up_f, down_f, dtype, True, True, crop))
    up, _, up_f, down_f, _ = plan[8]  # 276^2 -> 552^2, 128 channels
    for label, pre, post in (("no-affines", False, False), ("pre-only", True, False), ("post-only", False, True)):
        cases.append((label, BATCH, 128, 276, 276, up, up_f, down_f, torch.bfloat16, pre, post, None))
    for up in (2, 4):
        _, _, up_f, down_f, _ = next(p for p in plan if p[0] == up)
        cases.append((f"odd-up{up}", 3, 5, 37, 45, up, up_f, down_f, torch.float32, True, True, None))
        cases.append((f"odd-crop-up{up}", 3, 5, 37, 45, up, up_f, down_f, torch.bfloat16, True, True,
                      (2, 4, 37 * up // 2 - 5, 45 * up // 2 - 7)))
    return cases


def check_flrelu():
    """The filtered-lrelu kernel against its plain version. Tolerances:
    f32 1e-4 absolute (summation order; outputs are O(10)); bf16 one bf16
    ulp of the plain version's value (2^-7 relative) plus that f32
    allowance, since both compute in f32 from the same input and round once."""
    import torch

    from maua_tpu_torch.kernels import filtered_lrelu as FL

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], 0.0
    batch = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_bound_ms": 0.0}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # the plain version's convs in full f32
        for label, b, c, h, w, up, up_f, down_f, dtype, pre, post, crop in flrelu_cases():
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")

            x = (rnd(b, c, h, w) * 4).to(dtype)
            kw = {}
            if pre:
                kw = dict(pre_scale=torch.rand(b, c, generator=gen, device="cuda") + 0.5, pre_add=rnd(b, c) * 0.1)
            if post:
                kw["post_scale"] = torch.rand(b, c, generator=gen, device="cuda") + 0.5
            out = flrelu_call(FL, x, up_f, down_f, up, crop, kw)
            ref = flrelu_call(FL, x, up_f, down_f, up, crop, kw, plain=True)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"flrelu {label}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
            diff = (out.float() - ref.float()).abs()
            rtol = 2.0**-7 if dtype == torch.bfloat16 else 0.0
            ok = bool((diff <= rtol * ref.float().abs() + 1e-4).all())
            err = float(diff.max())
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"flrelu {label} disagrees with its plain version: max abs err {err}")
            del ref, diff, out
            # read x once, write the kept window of y once, and the per-plane scalars
            kept = crop[2] * crop[3] if crop else h * w * up * up // 4
            nbytes = (x.numel() + b * c * kept) * x.element_size() + 4 * b * c * len(kw)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            macs = flrelu_macs(b, c, h, w, up, crop)
            ops_ms = 2 * macs / F32_FLOPS * 1e3
            ms = cuda_time_ms(lambda: flrelu_call(FL, x, up_f, down_f, up, crop, kw))
            plain_ms = cuda_time_ms(lambda: flrelu_call(FL, x, up_f, down_f, up, crop, kw, plain=True), iters=3)
            bound_ms = max(bytes_ms, ops_ms)
            rows.append({"case": label, "shape": [b, c, h, w], "up": up, "crop": crop, "dtype": str(dtype).split(".")[-1],
                         "affines": sorted(kw), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                         "share_of_bound": bound_ms / ms, "bytes": nbytes, "macs": macs})
            if label.endswith("-bf16"):
                batch["ms"] += ms
                batch["plain_ms"] += plain_ms
                batch["bound_ms"] += bound_ms
                batch["ops_bound_ms"] += bound_ms if ops_ms > bytes_ms else 0.0
            del x
            torch.cuda.empty_cache()
    FL.reset_launches()  # the comparison launches do not count
    for r in rows:
        print(json.dumps({"flrelu": r}), flush=True)
    # the batch's bound is the sum of its calls' bounds; name the kind that makes up most of it
    return {"max_abs_err": worst, **{f"frame_batch_{k}": v for k, v in batch.items()},
            "bound_by": "operations" if 2 * batch["ops_bound_ms"] > batch["bound_ms"] else "bytes"}


ATTN_SHAPES = (  # (label, B, H, N, D, layout, q scale): the kernel's calls on a 512^2 SD image, then odd cases
    # the UNet hands the kernel (B, H, N, D) views of its (B, N, H * D) linears; the VAE a contiguous copy
    ("unet-l1", 2, 8, 1024, 80, "bnhd", 1.0),  # UNet self-attention at 32^2 latents, 640 channels, CFG batch 2
    ("unet-l2", 2, 8, 256, 160, "bnhd", 1.0),  # UNet self-attention at 16^2 latents, 1280 channels
    ("vae-mid", 1, 1, 4096, 512, "bhnd", 1.0),  # the VAE decoder's mid attention at 64^2 latents
    ("odd", 1, 3, 512, 64, "bhnd", 1.0),
    ("peaked", 2, 8, 1024, 80, "bnhd", 4.0),  # scores of std 4: the running max moves between key tiles
)
# launches of each shape in one 512^2 image: 50 LMS steps x 5 of each UNet level, one decode
ATTN_PER_IMAGE = {"unet-l1": 250, "unet-l2": 250, "vae-mid": 1}


def attention_tolerance(ref, dtype):
    """Elementwise bound on |kernel - plain|. f32: 1e-4 relative plus 1e-5
    absolute (sums over up to 4096 keys in another order). bf16: one bf16
    ulp of the output (2^-7 relative) plus 2^-5 of the output's RMS: the
    kernel rounds p against its running row max and the plain version
    against the final one, and those roundings, each within 2^-9 of p,
    average over the keys to a few 2^-9 of the output's scale."""
    import torch

    ref = ref.float()
    if dtype == torch.bfloat16:
        return 2.0**-7 * ref.abs() + 2.0**-5 * ref.pow(2).mean().sqrt()
    return 1e-4 * ref.abs() + 1e-5


def check_attention():
    """The flash-attention kernel against its plain version at the shapes
    and layouts of a 512^2 SD image, in f32 and bf16, with the tolerance of
    `attention_tolerance`. Bound: the larger of the bytes of q, k, v and o
    at 3.35 TB/s and 4 B H Nq Nk D operations at 67 TFLOP/s (f32, CUDA
    cores) or 989 TFLOP/s (bf16, tensor cores)."""
    import torch
    import torch.nn.functional as F

    from maua_tpu_torch.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = [], {"f32": 0.0, "bf16": 0.0}
    image = {"f32": {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}}
    image["bf16"] = dict(image["f32"])
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, b, h, n, d, layout, q_scale in ATTN_SHAPES:
            if layout == "bnhd":
                q, k, v = (torch.randn(b, n, h, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
                           for _ in range(3))
            else:
                q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
            q = (q * q_scale).to(dtype)
            out = A.flash_attention_fused(q, k, v)
            ref = A.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            rms = float(ref.float().pow(2).mean().sqrt())
            worst[tag] = max(worst[tag], err)
            if (out.shape != ref.shape or out.dtype != dtype or out.stride() != q.stride()
                    or not bool((diff <= attention_tolerance(ref, dtype)).all())):
                raise AssertionError(f"attention {label} {tag} disagrees with its plain version: max abs err {err}, "
                                     f"output rms {rms}, strides {out.stride()} for q's {q.stride()}")
            nbytes = 4 * q.numel() * q.element_size()
            flops = 4 * b * h * n * n * d
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
            ms = cuda_time_ms(lambda: A.flash_attention_fused(q, k, v))
            plain_ms = cuda_time_ms(lambda: A.flash_attention_plain(q, k, v), iters=5)
            library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=20)
            bound_ms = max(bytes_ms, ops_ms)
            rows.append({"case": label, "shape": [b, h, n, d], "layout": layout, "dtype": tag, "max_abs_err": err,
                         "err_over_rms": err / rms, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "share_of_bound": bound_ms / ms,
                         "tflops": flops / ms / 1e9})
            reps = ATTN_PER_IMAGE.get(label, 0)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms), ("library_ms", library_ms)):
                image[tag][key] += reps * val
            del q, k, v, out, ref, diff
            torch.cuda.empty_cache()
    A.reset_launches()  # the comparison launches do not count
    for r in rows:
        print(json.dumps({"attention": r}), flush=True)
    return {"max_abs_err": worst["f32"], "max_abs_err_bf16": worst["bf16"], "image_f32": image["f32"], "image_bf16": image["bf16"], "bound_by": "operations"}


MEL_SHAPES = (  # (label, signal shape, hop, n_mels), n_fft 2048
    ("3s-h512-m128", (66150,), 512, 128),  # onset strength and mfcc of the 3 s clip: each launch of ar_e2e
    ("3s-h1024-m512", (66150,), 1024, 512),  # spectral_max's shape
    ("180s-h512-m128", (3969000,), 512, 128),  # a song
    ("180s-h1024-m512", (3969000,), 1024, 512),
    ("batch4-3s-h512-m128", (4, 66150), 512, 128),
)


def check_mel():
    """The mel kernel against its plain version at each MEL_SHAPES case,
    max abs error <= 1e-4 of the largest output (the bar of the JAX
    package's mel kernel test). Bound: the larger of the signal read once
    plus the output written once at 3.35 TB/s, and per frame
    5 N log2 N (the N = n_fft / 2 point FFT) + 4 (N + 1) (split, power)
    + 2 nnz(mel basis) operations at 67 TFLOP/s (f32). Library: torch.stft
    (cuFFT) and the mel matmul, timed only. device_ms: the kernel's own
    time per launch (torch.profiler); at 3 s `ms` reads the wrapper's host
    time per call instead."""
    import numpy as np
    import torch

    from maua_tpu_torch.kernels import spectrogram as M

    gen = torch.Generator(device="cuda").manual_seed(0)
    window = torch.hann_window(2048, periodic=True, device="cuda")
    rows, worst = {}, 0.0
    for label, shape, hop, n_mels in MEL_SHAPES:
        t = torch.arange(shape[-1], device="cuda") / SR
        y = 0.3 * torch.sin(2 * math.pi * 440.0 * t) + 0.1 * torch.randn(*shape, generator=gen, device="cuda")
        basis = torch.from_numpy(M.mel_basis(float(SR), 2048, n_mels, 0.0, None)).cuda()
        out = M.melspectrogram(y, SR, 2048, hop, n_mels)
        ref = M.melspectrogram_plain(y, basis, 2048, hop)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        worst = max(worst, err)
        if out.shape != ref.shape or rel > 1e-4:
            raise AssertionError(f"mel {label} disagrees with its plain version: max abs err {err} ({rel} of the max)")
        batch, n_frames, half = int(np.prod(shape[:-1])), shape[-1] // hop, 1024
        nbytes = 4 * (y.numel() + out.numel())
        ops = batch * n_frames * (5 * half * math.log2(half) + 4 * (half + 1) + 2 * int((basis != 0).sum()))
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3

        def library():
            spec = torch.stft(y, 2048, hop, window=window, center=True, pad_mode="reflect", return_complex=True)
            return basis @ spec[..., :-1].abs().square()

        rows[label] = {"shape": list(shape), "hop": hop, "n_mels": n_mels, "max_abs_err": err, "err_over_max": rel,
                       "ms": cuda_time_ms(lambda: M.melspectrogram(y, SR, 2048, hop, n_mels)),
                       "device_ms": kernel_device_ms(lambda: M.melspectrogram(y, SR, 2048, hop, n_mels), "mel_kernel"),
                       "plain_ms": cuda_time_ms(lambda: M.melspectrogram_plain(y, basis, 2048, hop)),
                       "library_ms": cuda_time_ms(library), "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes, "ops": ops}
        del y, out, ref
    M.reset_launches()  # the comparison launches do not count
    for label, r in rows.items():
        print(json.dumps({"mel": {"case": label, **r}}), flush=True)
    return {"max_abs_err": worst, "cases": rows}


def kconv_cases():
    """(label, B, H, W, Ci, Co, dtype, epilogue): the last three 3x3 layers of
    a 1024^2 StyleGAN3 (channel counts from SG3Config's plan, 1044^2
    canvases) and RRDB's five growth convs (nf 64, gc 32) at 512^2, in bf16
    at batch 8 and in f32 at batch 1."""
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config

    cfg = SG3Config()
    _, _, _, _, sizes, channels = cfg.layer_plan()
    cases = []
    for dtype, b in ((torch.bfloat16, BATCH), (torch.float32, 1)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for i in range(cfg.num_layers - 4, cfg.num_layers - 1):  # the last layer is 1x1
            s = int(sizes[i])
            cases.append((f"sg3-L{i}-{tag}", b, s, s, int(channels[i]), int(channels[i + 1]), dtype, "modulated"))
        for j, ci in enumerate((64, 96, 128, 160, 192)):
            cases.append((f"rrdb-conv{j + 1}-{tag}", b, 512, 512, ci, 64 if j == 4 else 32, dtype,
                          "lrelu" if j < 4 else "bias"))
    return cases


def check_kconv():
    """kconv3x3 against its plain version (f32 conv, TF32 off, then the
    epilogue): |err| <= rtol |ref| + 1e-5 max |ref|, rtol 1e-5 in f32 and one
    bf16 ulp more in bf16. Bound: 2 B H W 9 Ci Co operations at 67 TFLOP/s
    (f32) or 989 TFLOP/s (bf16 tensor cores), or x, w and y once at
    3.35 TB/s. Library: F.conv2d alone in the working dtype on the
    channels-last view, timed only."""
    import torch
    import torch.nn.functional as F

    from maua_tpu_torch.kernels import kconv as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, worst = {}, 0.0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for label, b, h, w, ci, co, dtype, kind in kconv_cases():
            x = torch.randn(b, h, w, ci, generator=gen, device="cuda").to(dtype)
            wt = torch.randn(3, 3, ci, co, generator=gen, device="cuda") / math.sqrt(9 * ci)
            kw = {"bias": torch.randn(co, generator=gen, device="cuda") * 0.1}
            if kind == "modulated":
                kw.update(style=torch.rand(b, ci, generator=gen, device="cuda") + 0.5,
                          demod=torch.rand(b, co, generator=gen, device="cuda") + 0.5)
            elif kind == "lrelu":
                kw.update(alpha=0.2)
            out = K.kconv3x3(x, wt, **kw)
            ref = K.kconv3x3_plain(x, wt, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            rtol = 2.0**-7 + 1e-5 if dtype == torch.bfloat16 else 1e-5
            err = float(diff.max())
            worst = max(worst, err)
            if out.shape != ref.shape or not bool((diff <= rtol * ref.float().abs() + 1e-5 * ref.float().abs().max()).all()):
                raise AssertionError(f"kconv {label} disagrees with its plain version: max abs err {err}")
            del ref, diff
            ops = 2 * b * h * w * 9 * ci * co
            nbytes = (x.numel() + out.numel() + wt.numel()) * x.element_size()
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
            w_oihw = wt.to(dtype).permute(3, 2, 0, 1).contiguous()
            x_nchw = x.permute(0, 3, 1, 2)  # the NHWC tensor as a channels-last NCHW view
            iters = 5 if ops > 1e11 else 20
            ms = cuda_time_ms(lambda: K.kconv3x3(x, wt, **kw), iters=iters)
            rows[label] = {"shape": [b, h, w, ci, co], "dtype": str(dtype).split(".")[-1], "epilogue": kind,
                           "max_abs_err": err, "ms": ms, "tflops": ops / ms / 1e9,
                           "plain_ms": cuda_time_ms(lambda: K.kconv3x3_plain(x, wt, **kw), iters=iters),
                           "library_ms": cuda_time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), iters=iters),
                           "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                           "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            del x, out
            torch.cuda.empty_cache()
    K.reset_launches()  # the comparison launches do not count
    for label, r in rows.items():
        print(json.dumps({"kconv": {"case": label, **r}}), flush=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    sg3 = {k: sum(r[k] for label, r in rows.items() if label.startswith("sg3") and label.endswith("bf16")) for k in keys}
    f32 = {k: sum(r[k] for label, r in rows.items() if label.endswith("f32")) for k in keys}
    # a sum's bound is the sum of its calls' bounds; name the kind that is larger over them
    return {"max_abs_err": worst, "cases": rows, **{f"sg3_tail_bf16_{k}": v for k, v in sg3.items()},
            "sg3_tail_bf16_bound_by": "bytes" if sg3["bytes_ms"] >= sg3["ops_ms"] else "operations",
            **{f"f32_{k}": v for k, v in f32.items()},
            "f32_max_abs_err": max(r["max_abs_err"] for label, r in rows.items() if label.endswith("f32")),
            "f32_bound_by": "bytes" if f32["bytes_ms"] >= f32["ops_ms"] else "operations"}


def example_patch(repo: str, example: str) -> str:
    return os.path.join(repo, "maua_tpu_torch", "audiovisual", "patches", "examples", example)


def render_video(wav: str, patch_file: str, kernel_module, per_batch: int, stylegan_kwargs: dict, counted=(),
                 model_file=None):
    """Render the patch over the wav on the card through the normal entry
    point (from `model_file` when given); the kernel's launch count (and
    those of the modules in `counted`) is reset just before and read just
    after, and the kernel's must be `per_batch` times the render batches.
    Returns (frames, stats)."""
    import numpy as np
    import torch

    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch

    stages = {}
    torch.cuda.reset_peak_memory_stats()
    for module in (kernel_module, *counted):
        module.reset_launches()
    video, _ = generate_audiovisual_from_patch(
        wav, model_file, patch_file, renderer="memmap", renderer_kwargs={"batch_size": BATCH}, fps=FPS,
        out_size=(1024, 1024), device="cuda", stylegan_kwargs=stylegan_kwargs, stage_times=stages)
    launches = kernel_module.launches
    other = {f"{m.__name__.rsplit('.', 1)[-1]}_launches": m.launches for m in counted}
    n_frames = round(SECONDS * FPS)
    if video.shape != (n_frames, 1024, 1024, 3) or video.dtype != np.uint8:
        raise AssertionError(f"frames {video.shape} {video.dtype}, want ({n_frames}, 1024, 1024, 3) uint8")
    if video.min() == video.max():
        raise AssertionError("the rendered frames are constant")
    if np.all(video[0] == video[-1]):
        raise AssertionError("the first and last frames are identical: no modulation reached the frames")
    batches = math.ceil(n_frames / BATCH)
    if launches != per_batch * batches:
        raise AssertionError(f"{kernel_module.__name__} launched {launches} times, "
                             f"want {per_batch} x {batches} render batches")
    return video, {"frames": list(video.shape), "render_batches": batches, "launches": launches, **other,
                   "stage_seconds": stages, "render_fps": n_frames / stages["render"],
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_e2e(wav: str, repo: str):
    from maua_tpu_torch.kernels import epilogue as E

    return render_video(wav, example_patch(repo, "stylegan2.py"), E, 17, {"seed": 0})[1]


def run_sg3_e2e(wav: str, repo: str):
    from maua_tpu_torch.gan.stylegan3 import SG3Config
    from maua_tpu_torch.kernels import filtered_lrelu as FL

    cfg = SG3Config(img_resolution=1024, dtype="bfloat16")
    return render_video(wav, example_patch(repo, "stylegan3.py"), FL, cfg.num_layers - 1, {"cfg": cfg, "seed": 0})[1]


def mel_case(y, sr, n_fft, hop_length, n_mels, power, fmin, fmax) -> str:
    """The MEL_SHAPES label of a mel call on the card; raises for a call the
    mel phase does not time, since the record prices each launch by its case."""
    call = (tuple(y.shape), hop_length, n_mels, n_fft, float(power), float(sr), float(fmin), fmax)
    for label, shape, hop, mels in MEL_SHAPES:
        if call == (shape, hop, mels, 2048, 2.0, SR, 0.0, None):
            return label
    raise AssertionError(f"a mel launch of shape {call[0]}, n_fft {n_fft}, hop {hop_length}, {n_mels} mels, "
                         f"power {power}, sr {sr}, fmin {fmin}, fmax {fmax} has no MEL_SHAPES case")


@contextlib.contextmanager
def mel_cases_recorded():
    """Within the block, every mel call on the card appends its MEL_SHAPES
    case (mel_case) to the yielded list."""
    import inspect

    from maua_tpu_torch.kernels import spectrogram as M

    wrapper, signature, cases = M.melspectrogram, inspect.signature(M.melspectrogram), []

    def recording(*args, **kwargs):
        a = signature.bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        if a["y"].is_cuda:
            cases.append(mel_case(**a))
        return wrapper(*args, **kwargs)

    M.melspectrogram = recording
    try:
        yield cases
    finally:
        M.melspectrogram = wrapper


def case_counts(cases, launches: int, what: str) -> dict:
    """{MEL_SHAPES label: calls} of the recorded mel calls, which must be the kernel's launches."""
    if len(cases) != launches:
        raise AssertionError(f"{what}: {len(cases)} mel calls on the card, {launches} launches")
    return {c: cases.count(c) for c in sorted(set(cases))}


def run_ar_e2e(wav: str, tmp: str):
    """The mel-bearing patch (MEL_PATCH_BODY) over the 3 s wav through the
    full-width StyleGAN2 (seed 0), as e2e renders the example patch: the
    epilogue must launch 17 times per render batch and the mel kernel at
    least once. The MEL_SHAPES case of each mel launch is recorded."""
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.kernels import spectrogram as M

    patch_file = os.path.join(tmp, "mel_patch.py")
    with open(patch_file, "w") as f:
        f.write(MEL_PATCH_HEADER + MEL_PATCH_BODY)
    with mel_cases_recorded() as cases:
        _, out = render_video(wav, patch_file, E, 17, {"seed": 0}, counted=(M,))
    if out["spectrogram_launches"] < 1:
        raise AssertionError("the mel patch's video did not launch the mel kernel")
    return {**out, "mel_cases": case_counts(cases, out["spectrogram_launches"], "ar_e2e")}


AR_FEATURES = ("onsets", "pulse", "volume", "chroma", "tempo", "laplacian_segmentation")


def ar_features(y, sr: int, n_frames: int):
    """Every `ar` feature of MEL_PATCH_BODY over the signal y (on its
    device), each timed to a device synchronization: (outputs, seconds)."""
    import torch

    from maua_tpu_torch.audiovisual import audioreactive as ar

    calls = {
        "onsets": lambda: ar.onsets(y, sr, n_frames, margin=2, smooth=2, type="rosa"),
        "pulse": lambda: ar.pulse(y, sr, n_frames, type="rosa"),
        "volume": lambda: ar.volume(y, sr, n_frames, smooth=2),
        "chroma": lambda: ar.chroma(y, sr, n_frames, margin=2, type="stft"),
        "tempo": lambda: ar.tempo(y, sr, type="rosa"),
        "laplacian_segmentation": lambda: ar.laplacian_segmentation(y, sr, k=3),
    }
    outs, seconds = {}, {}
    for name in AR_FEATURES:
        t0 = time.perf_counter()
        outs[name] = calls[name]()
        if y.is_cuda:
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    for name in ("onsets", "pulse", "volume", "chroma"):
        if outs[name].shape[0] != n_frames or not bool(torch.isfinite(outs[name]).all()):
            raise AssertionError(f"ar.{name}: shape {tuple(outs[name].shape)}, want {n_frames} finite frames")
    return outs, seconds


def ar_features_child(song: str):
    """Run in a fresh process: the features over the song on the card twice,
    the first pass paying every first-use cost (cuFFT plans, kernel loads)."""
    import torch

    from maua_tpu_torch.audio.io import load_audio
    from maua_tpu_torch.kernels import spectrogram as M

    audio, sr, duration = load_audio(song)
    y = torch.from_numpy(audio).cuda()
    passes = []
    for _ in range(2):
        M.reset_launches()
        with mel_cases_recorded() as cases:
            outs, seconds = ar_features(y, sr, round(duration * FPS))
        passes.append({"seconds": seconds, "total_seconds": sum(seconds.values()), "mel_launches": M.launches,
                       "mel_cases": case_counts(cases, M.launches, "ar_features")})
    return {"audio_seconds": duration, "cold": passes[0], "warm": passes[1], "tempo": outs["tempo"][0],
            "segments": len(outs["laplacian_segmentation"][0])}


def run_ar_features(song: str):
    """The feature stage over a 180 s song in a fresh process (see
    ar_features_child), with that process's wall time from launch."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--ar-features-child", song],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the ar_features process failed:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["warm"]["mel_launches"] < 1:
        raise AssertionError("the features did not launch the mel kernel")
    return {**out, "process_seconds": time.perf_counter() - t0}


def ar_card_vs_cpu(song: str):
    """The first 20 s of the song through the features on the card and on
    the CPU, f32 with TF32 off: envelope errors (values in [0, 1]), tempo
    and segment boundaries."""
    import numpy as np
    import torch

    from maua_tpu_torch.audio.io import load_audio

    audio, sr, duration = load_audio(song, duration=20.0)
    n = round(duration * FPS)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:  # TF32 off for this phase only: the profiles after it run at PyTorch's defaults
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            card, _ = ar_features(torch.from_numpy(audio).cuda(), sr, n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    host, cpu_seconds = ar_features(torch.from_numpy(audio), sr, n)
    errs = {k: float((card[k].cpu() - host[k]).abs().max()) for k in ("onsets", "pulse", "volume", "chroma")}
    worst = max(errs.values())
    if worst > AR_REFERENCE_TOL:
        raise AssertionError(f"card vs CPU envelopes differ by {errs}, more than {AR_REFERENCE_TOL}")
    if card["tempo"][0] != host["tempo"][0]:
        raise AssertionError(f"card tempo {card['tempo'][0]} vs CPU {host['tempo'][0]}")
    (tc, lc), (th, lh) = card["laplacian_segmentation"], host["laplacian_segmentation"]
    same = len(tc) == len(th)
    return {"max_abs_err": errs, "tempo": [card["tempo"][0], host["tempo"][0]],
            "boundaries_card": tc.tolist(), "boundaries_cpu": th.tolist(),
            "boundary_max_diff_s": float(np.abs(tc - th).max()) if same else None,
            "labels_equal": same and bool(np.array_equal(lc, lh)), "cpu_seconds": cpu_seconds}


def profile_render_batch():
    """One render batch (8 frames at 1024^2, with noise and motion) under
    torch.profiler: device time by kernel, the epilogue's share, and the
    device's idle share of the batch's wall time."""
    import torch

    from maua_tpu_torch.gan.wrappers import StyleGAN2

    model = StyleGAN2(device="cuda", seed=0)
    ws = model.get_w_latents(f"0-{BATCH}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    noises = model.make_noise_pyramid(torch.randn(BATCH, 1, 64, 64, generator=gen, device="cuda"))
    motion = dict(translation=torch.full((BATCH, 2), 0.05, device="cuda"),
                  zoom=torch.full((BATCH,), 0.9, device="cuda"), rotation=torch.full((BATCH,), 3.0, device="cuda"))

    def batch():
        img = model.synthesizer(ws, noises=noises, **motion)
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu()

    return profile_batch(batch, "epilogue")


def profile_sg3_render_batch():
    """One StyleGAN3 render batch (8 frames at 1024^2, bf16 trunk, each
    frame with its own translation and rotation) under torch.profiler."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config, StyleGAN3

    model = StyleGAN3(cfg=SG3Config(dtype="bfloat16"), device="cuda", seed=0)
    ws = model.mapper(model.get_z_latents(f"0-{BATCH}"))
    translation = torch.linspace(0, 0.1, BATCH)[:, None].repeat(1, 2)
    rotation = torch.linspace(0, 10, BATCH)

    def batch():
        return np.stack(list(model.render(ws, translation, rotation, batch_size=BATCH)))

    return profile_batch(batch, "flrelu")


def profile_batch(batch, marker: str):
    """Run `batch` once to warm up, then once under torch.profiler: device
    time by kernel, the share of kernels whose name holds `marker`, and
    the device's idle share of the batch's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an operator's row repeats its kernels' time
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in kernels)
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    kernels.sort(key=lambda k: -k[1])
    marked_ms = sum(ms for name, ms, _ in kernels if marker in name)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "idle_share": max(0.0, 1 - device_ms / wall_ms),
            f"{marker}_ms": marked_ms, f"{marker}_share": marked_ms / device_ms,
            "top": [{"kernel": name[:90], "ms": ms, "count": n, "share": ms / device_ms}
                    for name, ms, n in kernels[:12]]}


def card_vs_cpu():
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.gan.wrappers import StyleGAN2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = SG2Config(dtype="float32")
    card = StyleGAN2(cfg=cfg, device="cuda", seed=0)
    cpu = StyleGAN2(cfg=cfg, params=card.params, device="cpu")
    gen = torch.Generator().manual_seed(1)
    noise = torch.randn(1, 1, 64, 64, generator=gen)
    inputs = dict(translation=torch.tensor([[0.05, 0.0]]), zoom=torch.tensor([0.9]), rotation=torch.tensor([3.0]))

    def frame(model):
        dev = model.device
        ws = model.get_w_latents("7")
        kw = {k: v.to(dev) for k, v in inputs.items()}
        noises = model.make_noise_pyramid(noise.to(dev))
        img = model.synthesizer(ws, noises=noises, **kw)
        return ((img + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy().astype(np.float64)

    a, b = frame(card), frame(cpu)
    mse = float(np.mean((a - b) ** 2))
    psnr = 10 * math.log10(255.0**2 / max(mse, 1e-12))
    if psnr < 40.0:
        raise AssertionError(f"card vs CPU frame PSNR {psnr:.2f} dB < 40 dB")
    return {"psnr_db": psnr, "max_abs_diff": float(np.abs(a - b).max())}


def sg3_card_vs_cpu():
    """One f32 StyleGAN3 frame (256^2: both up kinds, a bounded CPU time)
    with translation and rotation, on the card with the kernel and on
    the CPU with the plain version, TF32 off."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config, StyleGAN3
    from maua_tpu_torch.kernels import filtered_lrelu as FL

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = SG3Config(img_resolution=256, dtype="float32")
    card = StyleGAN3(cfg=cfg, device="cuda", seed=0)
    cpu = StyleGAN3(cfg=cfg, params=card.params, device="cpu")
    ws = card.mapper(card.get_z_latents("7"))

    def frame(model):
        img = model.synthesizer(ws.to(model.device), translation=(0.05, 0.0), rotation=3.0)
        return ((img.clamp(-1, 1) + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy().astype(np.float64)

    FL.reset_launches()
    a = frame(card)
    launches = FL.launches
    b = frame(cpu)
    if launches != cfg.num_layers - 1:
        raise AssertionError(f"the card's frame launched filtered_lrelu {launches} times, want {cfg.num_layers - 1}")
    mse = float(np.mean((a - b) ** 2))
    psnr = 10 * math.log10(255.0**2 / max(mse, 1e-12))
    if psnr < 40.0:
        raise AssertionError(f"StyleGAN3 card vs CPU frame PSNR {psnr:.2f} dB < 40 dB")
    return {"psnr_db": psnr, "max_abs_diff": float(np.abs(a - b).max()), "resolution": cfg.img_resolution}

SD_PROMPT = "a lighthouse on a cliff at dusk, oil painting"
SD_STEPS = 50  # LMS steps of the sd_e2e image
SD_BENCH_STEPS = 12  # CFG denoiser steps per timed call, as bench_diffusion.py counts them


def _default_tf32():
    """PyTorch's defaults (f32 matmuls in full f32, cuDNN convolutions in TF32);
    the reference phases before switch both off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}


def run_sd_e2e():
    """Text to image through the entry point: image_sample at 512^2, 50 LMS
    steps, cfg 5.0, a random-init full-width SD 1.x (UNet, VAE, CLIP text;
    seed 0) in the entry point's default dtype (f32). The attention
    kernel's launch count is reset just before and must be 501 just after:
    10 per UNet evaluation (5 at level 1, 5 at level 2) x 50, and the
    decoder's mid attention."""
    import torch

    from maua_tpu_torch.diffusion.image import image_sample
    from maua_tpu_torch.kernels import attention as A

    tf32 = _default_tf32()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    A.reset_launches()
    t0 = time.perf_counter()
    img = image_sample(text=SD_PROMPT, sizes=((512, 512),), timesteps=SD_STEPS, sampler="lms", cfg_scale=5.0,
                       device="cuda", seed=0, stage_times=stages, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.launches
    if tuple(img.shape) != (1, 512, 512, 3) or img.dtype != torch.float32 or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"image {tuple(img.shape)} {img.dtype}, want finite (1, 512, 512, 3) float32")
    if float(img.std()) < 1e-3:
        raise AssertionError("the image is constant")
    want = 10 * SD_STEPS + 1
    if launches != want:
        raise AssertionError(f"flash attention launched {launches} times, want {want}")
    return {"image": list(img.shape), "launches": launches, "stage_seconds": stages, "wall_seconds": wall,
            "steps_per_s": SD_STEPS / stages["sampling"], "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "value_range": [float(img.min()), float(img.max())], **tf32}


def _sd_step_fn(dtype: str):
    """One CFG denoiser step at 512^2 (a 2x-batched SD 1.x UNet evaluation
    through EpsDenoiser), random-init, as bench_diffusion.py builds it."""
    import numpy as np
    import torch

    from maua_tpu_torch.diffusion.models import unet as U
    from maua_tpu_torch.diffusion.samplers import make_ddpm_schedule
    from maua_tpu_torch.diffusion.wrappers import EpsDenoiser, cfg_denoiser

    cfg = U.UNetConfig(dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = U.init_params(cfg, gen)
    cond, uncond = (torch.randn(1, 77, 768, generator=gen, device="cuda") for _ in range(2))
    model = cfg_denoiser(EpsDenoiser(lambda x, t, context=None: U.forward(params, x, t, cfg, context),
                                     make_ddpm_schedule()), cond, uncond, 7.5)
    x0 = torch.randn(1, 4, 64, 64, generator=gen, device="cuda") * 14.6
    sigmas = np.linspace(14.6, 0.1, SD_BENCH_STEPS)

    def run():
        x = x0
        for s in sigmas:
            x = model(x, torch.full((1,), float(s), device="cuda"))
        return x

    def step():
        return model(x0, torch.full((1,), 14.6, device="cuda"))

    return run, step


def run_sd_steps():
    """The BASELINE metric as bench_diffusion.py defines it: CFG denoiser
    steps/s at 512^2, bf16 UNet, batch 1, the best of 3 timed calls of 12
    steps after a warm-up call."""
    import torch

    from maua_tpu_torch.kernels import attention as A

    tf32 = _default_tf32()
    with torch.no_grad():
        run, _ = _sd_step_fn("bfloat16")
        out = run()
        torch.cuda.synchronize()
        times = []
        A.reset_launches()
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("the bf16 denoiser steps gave non-finite values")
    if A.launches != 3 * SD_BENCH_STEPS * 10:
        raise AssertionError(f"flash attention launched {A.launches} times in {3 * SD_BENCH_STEPS} bf16 steps")
    return {"metric": "sd512_cfg_denoiser_steps_per_sec", "steps_per_s": SD_BENCH_STEPS / min(times),
            "step_ms": [t / SD_BENCH_STEPS * 1e3 for t in times], "dtype": "bfloat16", **tf32}


def profile_sd_step():
    """One CFG denoiser step at 512^2 under torch.profiler, in f32 (the
    sd_e2e path) and in bf16 (the sd_steps metric): device time by
    kernel, the attention kernel's share and the device's idle share."""
    import torch

    _default_tf32()
    out = {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            _, step = _sd_step_fn(dtype)
            out[dtype] = profile_batch(step, "flash_attention")
            torch.cuda.empty_cache()
    return out


def sd_card_vs_cpu():
    """The same random full-width SD 1.x on the card with the kernel and on
    the CPU with the plain versions, f32 with TF32 off, at 256^2 for 2 LMS
    steps and a decode, from the same latent noise; image PSNR (peak 2,
    the [-1, 1] range)."""
    import numpy as np
    import torch

    from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.prompt import TextPrompt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kw = dict(sampler="lms", timesteps=2, cfg_scale=5.0, image_size=256)
    card = StableDiffusion(device="cuda", seed=0, **kw)

    def cpu(tree):
        return {k: cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else (
            [cpu(v) for v in tree] if isinstance(tree, list) else tree.cpu())

    host = StableDiffusion(unet_params=cpu(card.unet_params), vae_params=cpu(card.vae_params),
                           text_params=cpu(card.text_params), device="cpu", **kw)
    noise = np.random.RandomState(0).randn(1, 32, 32, 4).astype(np.float32)
    img = np.zeros((1, 256, 256, 3), np.float32)
    A.reset_launches()
    a = card(img, [TextPrompt(SD_PROMPT)], 0.0, noise=noise).cpu().numpy()
    launches = A.launches
    t0 = time.perf_counter()
    b = host(img, [TextPrompt(SD_PROMPT)], 0.0, noise=noise).numpy()
    cpu_s = time.perf_counter() - t0
    if launches != 2 * 5 + 1:
        raise AssertionError(f"the card's image launched flash attention {launches} times, want 11")
    a, b = np.clip(a, -1, 1).astype(np.float64), np.clip(b, -1, 1).astype(np.float64)
    psnr = 10 * math.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-20))
    if psnr < 40.0:
        raise AssertionError(f"SD card vs CPU image PSNR {psnr:.2f} dB < 40 dB")
    return {"psnr_db": psnr, "max_abs_diff": float(np.abs(a - b).max()), "resolution": 256, "launches": launches,
            "cpu_seconds": cpu_s}


# ------------------------------------------------------------ checkpoint files
# chip_smoke writes its checkpoints itself, in the formats users bring: the
# port's parameter dicts hold NVIDIA's and CompVis's torch layouts, so writing
# is renaming.

def tree_map(fn, tree):
    """fn over the tensors of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def assert_trees_equal(got, want, what: str) -> int:
    """Every tensor of `got` equals its counterpart in `want` exactly (same
    keys, shapes, dtypes and values); returns the number of tensors."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise AssertionError(f"{what}: keys {sorted(got) if isinstance(got, dict) else type(got)} "
                                 f"!= {sorted(want)}")
        return sum(assert_trees_equal(got[k], want[k], f"{what}.{k}") for k in want)
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{what}: a list of {len(want)} expected")
        return sum(assert_trees_equal(g, w, f"{what}[{i}]") for i, (g, w) in enumerate(zip(got, want)))
    if got.dtype != want.dtype or not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} differs from its source "
                             f"{want.dtype} {tuple(want.shape)}")
    return 1


def ada_state_dict(tree, prefix: str = "") -> dict:
    """The port's StyleGAN2 (or mapping) parameter dict under NVIDIA's ADA
    state-dict names: the tree's path, with fc `w`/`b` named weight/bias."""
    out = {}
    for k, v in tree.items():
        name = {"w": "weight", "b": "bias"}.get(k, k)
        if isinstance(v, dict):
            out.update(ada_state_dict(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


def write_ada_pkl(path: str, sd: dict) -> None:
    """Write a state dict as stylegan2-ada-pytorch pickles its networks:
    every nn.Module reduces through torch_utils.persistence's
    `_reconstruct_persistent_obj(meta)`, meta a dnnlib.EasyDict whose
    `state` is the module's __dict__ (tensors in `_parameters`/`_buffers`,
    submodules in `_modules`). Stand-ins for those two modules exist only
    while pickling, so the loader has to read the file without them."""
    import pickle
    import types

    import torch

    class Node(torch.nn.Module):
        pass

    root = Node()
    for key, val in sd.items():
        *parents, leaf = key.split(".")
        node = root
        for p in parents:
            if p not in node._modules:
                node.add_module(p, Node())
            node = node._modules[p]
        if leaf in ("noise_const", "w_avg"):  # ADA's buffers; the rest are parameters
            node.register_buffer(leaf, val.detach().clone())
        else:
            setattr(node, leaf, torch.nn.Parameter(val.detach().clone(), requires_grad=False))

    persistence = types.ModuleType("torch_utils.persistence")
    dnnlib = types.ModuleType("dnnlib")

    def _reconstruct_persistent_obj(meta):  # referenced by name only; never called
        raise AssertionError("the writer's stand-in must not run")

    class EasyDict(dict):
        pass

    _reconstruct_persistent_obj.__module__ = persistence.__name__
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    EasyDict.__module__, EasyDict.__qualname__ = "dnnlib", "EasyDict"
    persistence._reconstruct_persistent_obj, dnnlib.EasyDict = _reconstruct_persistent_obj, EasyDict
    stand_ins = {"torch_utils": types.ModuleType("torch_utils"), "torch_utils.persistence": persistence,
                 "dnnlib": dnnlib}

    class Pickler(pickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.nn.Module):
                meta = EasyDict(type="class", version=6, module_src="# source stripped",
                                class_name=type(obj).__name__, state=dict(obj.__dict__))
                return _reconstruct_persistent_obj, (meta,)
            return NotImplemented

    sys.modules.update(stand_ins)
    try:
        with open(path, "wb") as f:
            Pickler(f, protocol=4).dump({"G": root, "D": None, "G_ema": root, "training_set_kwargs": None,
                                         "augment_pipe": None})
    finally:
        for name in stand_ins:
            sys.modules.pop(name, None)


def rosinality_state_dict(params, cfg) -> dict:
    """The port's StyleGAN2 parameters under rosinality's names (the inverse
    of the loader's rosinality_to_ada)."""
    syn, out = params["synthesis"], {}

    def conv(prefix, p, noise_name):
        out[f"{prefix}.conv.weight"] = p["weight"][None]
        out[f"{prefix}.activate.bias"] = p["bias"]
        out[f"{prefix}.conv.modulation.weight"] = p["affine"]["w"]
        out[f"{prefix}.conv.modulation.bias"] = p["affine"]["b"]
        out[f"{prefix}.noise.weight"] = p["noise_strength"].reshape(1)
        out[f"noises.{noise_name}"] = p["noise_const"][None, None]

    def torgb(prefix, p):
        out[f"{prefix}.conv.weight"] = p["weight"][None]
        out[f"{prefix}.bias"] = p["bias"].reshape(1, -1, 1, 1)
        out[f"{prefix}.conv.modulation.weight"] = p["affine"]["w"]
        out[f"{prefix}.conv.modulation.bias"] = p["affine"]["b"]

    for i in range(cfg.mapping_layers):
        out[f"style.{i + 1}.weight"] = params["mapping"][f"fc{i}"]["w"]
        out[f"style.{i + 1}.bias"] = params["mapping"][f"fc{i}"]["b"]
    out["input.input"] = syn["b4"]["const"][None]
    conv("conv1", syn["b4"]["conv1"], "noise_0")
    torgb("to_rgb1", syn["b4"]["torgb"])
    for j, res in enumerate(cfg.block_resolutions[1:]):
        for c in (0, 1):
            n = 2 * j + c
            conv(f"convs.{n}", syn[f"b{res}"][f"conv{c}"], f"noise_{n + 1}")
        torgb(f"to_rgbs.{j}", syn[f"b{res}"]["torgb"])
    return out


def sg3_source_params(cfg, seed: int = 0, device: str = "cuda"):
    """Random StyleGAN3 parameters (the port's init, seed on `device`) as an
    NVIDIA file can hold them, and that file's state dict. NVIDIA stores the
    input's 1x1 mixing weight raw and divides by sqrt(channels) when it
    runs; the port bakes the division in when it loads (in float64, rounded
    to float32), so the source's weight is the one the raw value encodes."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan3 import init_params

    src = tree_map(lambda t: t.cpu(), init_params(cfg, torch.Generator(device=device).manual_seed(seed)))
    c = src["input"]["weight"].shape[1]
    raw = (src["input"]["weight"][:, :, 0, 0].double() * math.sqrt(c)).float()
    src["input"]["weight"] = torch.from_numpy((raw.numpy() / np.sqrt(c)).astype(np.float32)[:, :, None, None])
    _, _, _, _, sizes, channels = cfg.layer_plan()
    sd = ada_state_dict({"mapping": src["mapping"]})
    sd.update({f"synthesis.input.{k}": v for k, v in ada_state_dict(src["input"]).items()})
    sd["synthesis.input.weight"] = raw
    for i, layer in enumerate(src["layers"]):
        name = f"synthesis.L{i}_{int(sizes[i + 1])}_{int(channels[i + 1])}"
        sd.update({f"{name}.{k}": v for k, v in ada_state_dict(layer).items()})
    return src, sd


def compvis_state_dict(unet, vae, text) -> dict:
    """The port's SD 1.x UNet, VAE and CLIP-text parameters under the names
    of a CompVis checkpoint (the inverse of diffusion/load.py's converters)."""
    sd = {}

    def put(name, p):  # linear and conv {w, b}, norms {scale, bias}
        for k, n in (("w", "weight"), ("b", "bias"), ("scale", "weight"), ("bias", "bias")):
            if k in p:
                sd[f"{name}.{n}"] = p[k]

    def resblock(name, p):
        put(f"{name}.in_layers.0", p["norm1"])
        put(f"{name}.in_layers.2", p["conv1"])
        put(f"{name}.emb_layers.1", p["emb"])
        put(f"{name}.out_layers.0", p["norm2"])
        put(f"{name}.out_layers.3", p["conv2"])
        if "skip" in p:
            put(f"{name}.skip_connection", p["skip"])

    def spatial(name, p):
        s = p["spatial"]
        put(f"{name}.norm", s["norm"])
        put(f"{name}.proj_in", s["proj_in"])
        put(f"{name}.proj_out", s["proj_out"])
        for d, blk in enumerate(s["blocks"]):
            b = f"{name}.transformer_blocks.{d}"
            for k in ("norm1", "norm2", "norm3"):
                put(f"{b}.{k}", blk[k])
            for a in ("attn1", "attn2"):
                for k in ("to_q", "to_k", "to_v"):
                    put(f"{b}.{a}.{k}", blk[a][k])
                put(f"{b}.{a}.to_out.0", blk[a]["to_out"])
            put(f"{b}.ff.net.0.proj", blk["ff_in"])
            put(f"{b}.ff.net.2", blk["ff_out"])

    u = "model.diffusion_model"
    put(f"{u}.time_embed.0", unet["time_mlp1"])
    put(f"{u}.time_embed.2", unet["time_mlp2"])
    put(f"{u}.input_blocks.0.0", unet["conv_in"])
    for i, blk in enumerate(unet["downs"], start=1):
        if "down" in blk:
            put(f"{u}.input_blocks.{i}.0.op", blk["down"])
            continue
        resblock(f"{u}.input_blocks.{i}.0", blk["res"])
        if "attn" in blk:
            spatial(f"{u}.input_blocks.{i}.1", blk["attn"])
    resblock(f"{u}.middle_block.0", unet["mid"]["res1"])
    spatial(f"{u}.middle_block.1", unet["mid"]["attn"])
    resblock(f"{u}.middle_block.2", unet["mid"]["res2"])
    for i, blk in enumerate(unet["ups"]):
        resblock(f"{u}.output_blocks.{i}.0", blk["res"])
        if "attn" in blk:
            spatial(f"{u}.output_blocks.{i}.1", blk["attn"])
        if "up" in blk:
            put(f"{u}.output_blocks.{i}.{2 if 'attn' in blk else 1}.conv", blk["up"])
    put(f"{u}.out.0", unet["norm_out"])
    put(f"{u}.out.2", unet["conv_out"])

    def vres(name, p):
        for k in ("norm1", "conv1", "norm2", "conv2"):
            put(f"{name}.{k}", p[k])
        if "skip" in p:
            put(f"{name}.nin_shortcut", p["skip"])

    def vmid(name, p):
        vres(f"{name}.block_1", p["res1"])
        put(f"{name}.attn_1.norm", p["attn"]["norm"])
        for k in ("q", "k", "v"):
            put(f"{name}.attn_1.{k}", p["attn"][k])
        put(f"{name}.attn_1.proj_out", p["attn"]["proj"])
        vres(f"{name}.block_2", p["res2"])

    v, enc, dec = "first_stage_model", vae["encoder"], vae["decoder"]
    put(f"{v}.encoder.conv_in", enc["conv_in"])
    level, b = 0, 0
    for blk in enc["blocks"]:
        if "down" in blk:
            put(f"{v}.encoder.down.{level}.downsample.conv", blk["down"])
            level, b = level + 1, 0
        else:
            vres(f"{v}.encoder.down.{level}.block.{b}", blk["res"])
            b += 1
    vmid(f"{v}.encoder.mid", enc["mid"])
    put(f"{v}.encoder.norm_out", enc["norm_out"])
    put(f"{v}.encoder.conv_out", enc["conv_out"])
    put(f"{v}.quant_conv", enc["quant_conv"])
    put(f"{v}.post_quant_conv", dec["post_quant_conv"])
    put(f"{v}.decoder.conv_in", dec["conv_in"])
    vmid(f"{v}.decoder.mid", dec["mid"])
    b = 0  # the decoder starts at the encoder's last level
    for blk in dec["blocks"]:
        if "up" in blk:
            put(f"{v}.decoder.up.{level}.upsample.conv", blk["up"])
            level, b = level - 1, 0
        else:
            vres(f"{v}.decoder.up.{level}.block.{b}", blk["res"])
            b += 1
    put(f"{v}.decoder.norm_out", dec["norm_out"])
    put(f"{v}.decoder.conv_out", dec["conv_out"])

    t = "cond_stage_model.transformer.text_model"
    sd[f"{t}.embeddings.token_embedding.weight"] = text["token_embedding"]
    sd[f"{t}.embeddings.position_embedding.weight"] = text["positional_embedding"]
    put(f"{t}.final_layer_norm", text["ln_final"])
    names = {"ln1": "layer_norm1", "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "out": "self_attn.out_proj", "ln2": "layer_norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i, blk in enumerate(text["blocks"]):
        for k, n in names.items():
            put(f"{t}.encoder.layers.{i}.{n}", blk[k])
    return sd


def _put_conv(sd: dict, name: str, p) -> None:
    sd[f"{name}.weight"], sd[f"{name}.bias"] = p["w"], p["b"]


def _cpu_state_dict(sd: dict) -> dict:
    return {k: v.detach().float().cpu().contiguous() for k, v in sd.items()}


def rrdb_state_dict(params) -> dict:
    """The port's RRDBNet tree as a basicsr RRDBNet state dict."""
    sd = {}
    _put_conv(sd, "conv_first", params["conv_first"])
    for b, blk in enumerate(params["body"]):
        for r in range(1, 4):
            for c in range(1, 6):
                _put_conv(sd, f"body.{b}.rdb{r}.conv{c}", blk[f"rdb{r}"][f"conv{c}"])
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _put_conv(sd, name, params[name])
    return _cpu_state_dict(sd)


def srvgg_state_dict(params) -> dict:
    """The port's SRVGG tree as a realesrgan SRVGGNetCompact state dict (a flat
    Sequential: conv, prelu, ..., conv)."""
    sd = {}
    for i, (p, a) in enumerate(zip(params["convs"], params["prelu"])):
        _put_conv(sd, f"body.{2 * i}", p)
        sd[f"body.{2 * i + 1}.weight"] = a
    _put_conv(sd, f"body.{2 * len(params['convs'])}", params["conv_last"])
    return _cpu_state_dict(sd)


def swinir_state_dict(params, cfg) -> dict:
    """The port's SwinIR tree as an official SwinIR state dict."""
    sd = {}

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["g"], p["b"]

    def resi(base, p):
        if cfg.resi_connection == "1conv":
            _put_conv(sd, base, p["conv"])
        else:
            for i, name in enumerate(("conv0", "conv1", "conv2")):
                _put_conv(sd, f"{base}.{2 * i}", p[name])

    _put_conv(sd, "conv_first", params["conv_first"])
    ln("patch_embed.norm", params["patch_norm"])
    for li, layer in enumerate(params["layers"]):
        for bi, blk in enumerate(layer["blocks"]):
            base = f"layers.{li}.residual_group.blocks.{bi}"
            ln(f"{base}.norm1", blk["norm1"])
            ln(f"{base}.norm2", blk["norm2"])
            for name, key in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
                _put_conv(sd, f"{base}.{name}", blk[key])
            sd[f"{base}.attn.relative_position_bias_table"] = blk["rpb"]
        resi(f"layers.{li}.conv", layer["conv"])
    ln("norm", params["norm"])
    resi("conv_after_body", params["conv_after_body"])
    _put_conv(sd, "conv_before_upsample.0", params["conv_before_upsample"])
    for name in ("conv_up1", "conv_up2", "conv_hr", "conv_last"):
        _put_conv(sd, name, params[name])
    return _cpu_state_dict(sd)


def upconv7_json(params) -> list:
    """The port's UpConv7 tree as a waifu2x JSON model (a list of layers, the
    last a transposed conv with its weight (in, out, kh, kw))."""
    layers = []
    for name in [f"conv{i}" for i in range(6)] + ["deconv"]:
        w, b = params[name]["w"].detach().float().cpu(), params[name]["b"].detach().float().cpu()
        n_in, n_out = (w.shape[0], w.shape[1]) if name == "deconv" else (w.shape[1], w.shape[0])
        layers.append({"class_name": "nn.SpatialFullConvolution" if name == "deconv" else "nn.SpatialConvolutionMM",
                       "nInputPlane": n_in, "nOutputPlane": n_out, "kW": w.shape[3], "kH": w.shape[2],
                       "weight": w.tolist(), "bias": b.tolist()})
    return layers


def run_gan_load(wav: str, repo: str, tmp: str):
    """Full-width StyleGAN2 (config-f, 1024^2) and StyleGAN3 (config T,
    1024^2) generators from seed 0, written as an NVIDIA ADA .pkl and a
    rosinality .pt (StyleGAN2) and an NVIDIA-named .pt state dict
    (StyleGAN3), loaded back with load_network: every tensor must equal its
    source exactly. Then the e2e clip through the normal entry point with
    `model_file=` and with the source passed as `params=`: the frames must
    be the same bytes, with 17 epilogue and 13 filtered-lrelu launches per
    render batch of each."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.load import load_network
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.gan.stylegan2 import init_params as sg2_init
    from maua_tpu_torch.gan.stylegan3 import SG3Config
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.kernels import filtered_lrelu as FL

    sg2_cfg, sg3_cfg = SG2Config(dtype="bfloat16"), SG3Config(dtype="bfloat16")
    sg2 = tree_map(lambda t: t.cpu(), sg2_init(sg2_cfg, torch.Generator(device="cuda").manual_seed(0)))
    sg3, sg3_sd = sg3_source_params(sg3_cfg)
    files = {"sg2_ada.pkl": (sg2, sg2_cfg), "sg2_rosinality.pt": (sg2, sg2_cfg), "sg3_nvidia.pt": (sg3, sg3_cfg)}
    paths = {name: os.path.join(tmp, name) for name in files}
    write_ada_pkl(paths["sg2_ada.pkl"], ada_state_dict(sg2))
    torch.save({"g_ema": rosinality_state_dict(sg2, sg2_cfg), "latent_avg": sg2["mapping"]["w_avg"]},
               paths["sg2_rosinality.pt"])
    torch.save(sg3_sd, paths["sg3_nvidia.pt"])
    out = {}
    for name, (src, cfg) in files.items():
        t0 = time.perf_counter()
        params, loaded_cfg = load_network(paths[name], dtype="bfloat16")
        seconds = time.perf_counter() - t0
        if loaded_cfg != cfg:
            raise AssertionError(f"{name}: loaded config {loaded_cfg}, want {cfg}")
        n = assert_trees_equal(params, src, name)
        out[name] = {"megabytes": os.path.getsize(paths[name]) / 2**20, "load_seconds": seconds, "tensors": n,
                     "parameters": sum(t.numel() for t in _leaves(params))}
    for name, patch, module, per_batch, src, cfg in (
            ("sg2_ada.pkl", "stylegan2.py", E, 17, sg2, sg2_cfg),
            ("sg3_nvidia.pt", "stylegan3.py", FL, sg3_cfg.num_layers - 1, sg3, sg3_cfg)):
        patch_file = example_patch(repo, patch)
        loaded, stats = render_video(wav, patch_file, module, per_batch, {"dtype": "bfloat16"}, model_file=paths[name])
        direct, _ = render_video(wav, patch_file, module, per_batch, {"cfg": cfg, "params": src})
        if not np.array_equal(loaded, direct):
            raise AssertionError(f"{name}: the frames rendered from the file differ from those of its source "
                                 f"({int((loaded != direct).sum())} bytes)")
        out[name].update(render_fps=stats["render_fps"], launches=stats["launches"], frames_bit_identical=True,
                         render_batches=stats["render_batches"])
        del loaded, direct
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


SD_LOAD_STEPS = 10  # LMS steps of the sd_load images


def run_sd_load(tmp: str):
    """A full-width SD 1.x checkpoint (UNet, VAE, CLIP text from seed 0) in
    fp16 under CompVis's names, as the public SD 1.x files ship, saved with
    torch.save and loaded back with load_stable_diffusion: every tensor
    must equal the fp16-rounded source. Then one 512^2 image in f32
    (SD_LOAD_STEPS LMS steps, cfg 5) through image_sample from the loaded
    trees and from the fp16-rounded source trees: PSNR >= 60 dB (the same
    bytes expected), 10 attention launches per UNet evaluation and 1 per
    decode for each."""
    import numpy as np
    import torch

    from maua_tpu_torch.diffusion.image import image_sample
    from maua_tpu_torch.diffusion.load import load_stable_diffusion
    from maua_tpu_torch.diffusion.models import unet as U
    from maua_tpu_torch.diffusion.models import vae as V
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.text import clip_text as C

    gen = torch.Generator(device="cuda").manual_seed(0)  # the order StableDiffusion draws them in
    src = [U.init_params(U.SD1_UNET, gen), V.init_params(V.VAEConfig(), gen), C.init_params(C.CLIPTextConfig(), gen)]
    src = tree_map(lambda t: t.half().cpu(), src)
    path = os.path.join(tmp, "sd-v1-synthetic.ckpt")
    t0 = time.perf_counter()
    torch.save({"state_dict": compvis_state_dict(*src)}, path)
    save_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_stable_diffusion(path)
    load_seconds = time.perf_counter() - t0
    src = tree_map(lambda t: t.float(), src)
    n = sum(assert_trees_equal(got, want, name) for got, want, name in zip(loaded, src, ("unet", "vae", "text")))
    out = {"gigabytes": os.path.getsize(path) / 2**30, "save_seconds": save_seconds, "load_seconds": load_seconds,
           "tensors": n, "parameters": sum(t.numel() for t in _leaves(src))}
    os.remove(path)
    _default_tf32()
    images = {}
    for name, (unet, vae, text) in (("loaded", loaded), ("direct", src)):
        A.reset_launches()
        img = image_sample(text=SD_PROMPT, sizes=((512, 512),), timesteps=SD_LOAD_STEPS, sampler="lms", cfg_scale=5.0,
                           device="cuda", seed=0, verbose=False, unet_params=unet, vae_params=vae, text_params=text)
        torch.cuda.synchronize()
        want = 10 * SD_LOAD_STEPS + 1
        if A.launches != want:
            raise AssertionError(f"sd_load ({name}): flash attention launched {A.launches} times, want {want}")
        if tuple(img.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"sd_load ({name}): image {tuple(img.shape)}, want finite (1, 512, 512, 3)")
        images[name] = img.cpu().numpy().astype(np.float64)
        out[f"{name}_launches"] = A.launches
        torch.cuda.empty_cache()
    a, b = (np.clip(images[k], -1, 1) for k in ("loaded", "direct"))
    mse = float(np.mean((a - b) ** 2))
    psnr = 10 * math.log10(4.0 / max(mse, 1e-20))
    if psnr < 60.0:
        raise AssertionError(f"sd_load: the image from the file is {psnr:.2f} dB from the direct one, < 60 dB")
    return {**out, "psnr_db": psnr, "bit_identical": bool(np.array_equal(images["loaded"], images["direct"])),
            "max_abs_diff": float(np.abs(a - b).max())}


@contextlib.contextmanager
def synchronous_delivery():
    """Within the block the facades' render hands out frames the way the
    port did before it pipelined them: each batch (converted to I420 on the
    card for yuv420p) is copied synchronously into pageable memory before
    the next batch is synthesized."""
    from maua_tpu_torch.ops import video as V

    pipelined = V.pipelined_frames

    def synchronous(batches, pix_fmt="rgb24"):
        for item in batches:
            batch, n = item if isinstance(item, tuple) else (item, None)
            if pix_fmt == "yuv420p":
                batch = V.rgb_to_yuv420(batch)
            frames = batch.cpu().numpy()
            yield from frames[: frames.shape[0] if n is None else n]

    V.pipelined_frames = synchronous
    try:
        yield
    finally:
        V.pipelined_frames = pipelined


DELIVERY_FRAMES = 96  # frames per timed render: 12 batches of 8, 3 of 32
DELIVERY_ROUTES = (("sync", "rgb24"), ("pipelined", "rgb24"), ("pipelined", "yuv420p"), ("sync", "yuv420p"))
DELIVERY_ROUNDS = 3  # timed renders of each route: 2 per round, in the order A B C D D C B A


def device_busy_ms(prof) -> float:
    """The union of the device intervals (kernels, copies) in a profile, ms."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def run_delivery():
    """Render fps of DELIVERY_FRAMES frames at 1024^2 through each facade's
    render, StyleGAN2 (bf16 top resolutions, noise and motion) and
    StyleGAN3 (bf16 trunk, per-frame translation and rotation), at batch 8
    and 32, by route: the synchronous pageable copy (sync, chip_smoke's
    own) and pipelined_frames, each in rgb24 and yuv420p, in the order of
    DELIVERY_ROUTES and then reversed (A B C D D C B A), DELIVERY_ROUNDS
    times for each case.
    Each route's frames must be the bytes of the synchronous route's in
    the same format. Beside it: the device's idle share over a whole render
    of 4 batches (3 at batch 32; torch.profiler, the union of device
    intervals over the wall time), one batch's device-to-host copy into pinned and into pageable
    memory, and rgb_to_yuv420 on the card against the CPU, byte for byte."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maua_tpu_torch.gan.stylegan3 import SG3Config, StyleGAN3
    from maua_tpu_torch.gan.wrappers import StyleGAN2
    from maua_tpu_torch.ops.video import rgb_to_yuv420

    _default_tf32()
    n = DELIVERY_FRAMES
    gen = torch.Generator(device="cuda").manual_seed(3)
    sg2 = StyleGAN2(device="cuda", seed=0)
    sg2_inputs = dict(latents=sg2.get_w_latents(f"0-{n}"),
                      noises=sg2.make_noise_pyramid(torch.randn(n, 1, 64, 64, generator=gen, device="cuda")),
                      translation=torch.linspace(0, 0.1, n, device="cuda")[:, None].repeat(1, 2),
                      zoom=torch.linspace(1.0, 0.8, n, device="cuda"),
                      rotation=torch.linspace(0, 5, n, device="cuda"))
    sg3 = StyleGAN3(cfg=SG3Config(dtype="bfloat16"), device="cuda", seed=0)
    sg3_inputs = dict(latent_w_plus=sg3.mapper(sg3.get_z_latents(f"0-{n}")),
                      translation=torch.linspace(0, 0.1, n)[:, None].repeat(1, 2), rotation=torch.linspace(0, 10, n))
    nets = {"stylegan2": (sg2, sg2_inputs), "stylegan3": (sg3, sg3_inputs)}

    def head(tree, k):  # the first k frames of every per-frame input
        if isinstance(tree, dict):
            return {key: head(v, k) for key, v in tree.items()}
        return tree[:k]

    def render(model, inputs, batch, route, pix_fmt, frames=n, keep=False):
        """Consume a whole render of the first `frames` frames; with `keep`, return them."""
        ctx = synchronous_delivery() if route == "sync" else contextlib.nullcontext()
        kept = []
        with ctx:
            for f in model.render(**head(inputs, frames), batch_size=batch, pix_fmt=pix_fmt):
                if keep:
                    kept.append(f)
        return kept

    out = {"frames": n, "routes": [f"{r}-{p}" for r, p in DELIVERY_ROUTES]}
    for net, (model, inputs) in nets.items():
        for batch in (8, 32):
            case = f"{net}-b{batch}"
            ref = {}
            for route, pix_fmt in DELIVERY_ROUTES:  # warm-up and the bytes of each route
                frames = np.stack(render(model, inputs, batch, route, pix_fmt, keep=True))
                ref.setdefault(pix_fmt, frames)
                if frames.shape[0] != n or not np.array_equal(frames, ref[pix_fmt]):
                    raise AssertionError(f"delivery {case}: the {route} {pix_fmt} frames differ from the sync route's")
                del frames
            ref.clear()
            fps = {f"{r}-{p}": [] for r, p in DELIVERY_ROUTES}
            for route, pix_fmt in (DELIVERY_ROUTES + DELIVERY_ROUTES[::-1]) * DELIVERY_ROUNDS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(model, inputs, batch, route, pix_fmt)
                fps[f"{route}-{pix_fmt}"].append(n / (time.perf_counter() - t0))
            idle, batches = {}, min(4, n // batch)
            for route, pix_fmt in DELIVERY_ROUTES:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    render(model, inputs, batch, route, pix_fmt, frames=batches * batch)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                busy = device_busy_ms(prof)
                idle[f"{route}-{pix_fmt}"] = {"batches": batches, "wall_ms_per_batch": wall_ms / batches,
                                              "busy_ms_per_batch": busy / batches,
                                              "idle_share": max(0.0, 1 - busy / wall_ms) if busy else "not measured"}
            out[case] = {"fps": fps, "fps_median": {k: float(np.median(v)) for k, v in fps.items()}, "profile": idle}
            print(json.dumps({"delivery": {"case": case, **out[case]}}), flush=True)
            torch.cuda.empty_cache()

    copies = {}
    for batch in (8, 32):
        rgb = torch.randint(0, 256, (batch, 1024, 1024, 3), generator=gen, device="cuda", dtype=torch.uint8)
        for fmt, x in (("rgb24", rgb), ("yuv420p", rgb_to_yuv420(rgb))):
            pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)

            def host_ms(fn, reps=10):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) / reps * 1e3

            copies[f"b{batch}-{fmt}"] = {
                "megabytes": x.numel() / 1e6,
                "pinned_ms": host_ms(lambda: pinned.copy_(x, non_blocking=True)),
                "pageable_ms": host_ms(lambda: x.cpu()),
            }
        if not np.array_equal(rgb_to_yuv420(rgb).cpu().numpy(), rgb_to_yuv420(rgb.cpu()).numpy()):
            raise AssertionError(f"rgb_to_yuv420 on the card differs from the CPU at batch {batch}")
        del rgb, x, pinned
    frames = np.stack(render(sg2, sg2_inputs, 8, "pipelined", "rgb24", frames=8, keep=True))
    if not np.array_equal(rgb_to_yuv420(torch.from_numpy(frames).cuda()).cpu().numpy(),
                          rgb_to_yuv420(torch.from_numpy(frames)).numpy()):
        raise AssertionError("rgb_to_yuv420 on the card differs from the CPU on rendered frames")
    out["copies"] = copies
    out["yuv420_card_equals_cpu"] = True
    return out


# ------------------------------------------------------------ super-resolution
SUPER_BATCH, SUPER_SIZE = 8, 256  # BASELINE config #4 as bench_super.py defines it: 8 frames, 256^2 -> 1024^2
SUPER_TIMED = 7  # batches timed after two warm-ups; the median is reported
SUPER_FORM_BATCHES = 5  # batches of each turn of the dense-block forms' A/B
# one model of each registry kind but latent-diffusion, on a small input (SwinIR's odd: its window padding)
SUPER_KINDS = (("RealESRGAN-xsx4-animevideo", (64, 64)), ("SwinIR-M-DFO-GAN", (61, 75)),
               ("SwinIR-L-DFOWMFC-GAN", (61, 75)), ("waifu2x-photo-noise1", (64, 64)), ("CARN", (64, 64)))
SUPER_LOAD = ("RealESRGAN-x4plus", "RealESRGAN-xsx4-animevideo", "SwinIR-M-DFO-GAN", "waifu2x-anime-noise0")
SUPER_REFERENCE = ("RealESRGAN-x4plus", "RealESRGAN-xsx4-animevideo", "SwinIR-M-DFO-GAN", "waifu2x-anime-noise0",
                   "CARN")


def rrdb_macs(cfg, h: int, w: int) -> int:
    """Multiply-adds of one RRDBNet forward on an h x w input: the 3 x 23
    dense blocks, the head and body convs at h x w, the x2 conv at 2h x 2w,
    and the x4, hr and last convs at 4h x 4w (scale 4)."""
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    rdb = sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5)) * 9
    low = cfg.num_in_ch * nf * 9 + 3 * cfg.num_block * rdb + nf * nf * 9
    high = nf * nf * 9 * 4 + (2 * nf * nf * 9 + nf * cfg.num_out_ch * 9) * 16
    return (low + high) * h * w


@contextlib.contextmanager
def first_rungs_only(what: str):
    """Fails if an out-of-memory ladder (the upscaler's tile rungs, the
    diffusion pipeline's skipped super-resolution and halved tile batches)
    went past its first rung: records the rungs the upscaler tried and
    reads the pipeline's "device OOM" prints (echoed after)."""
    import io

    from maua_tpu_torch import oom
    from maua_tpu_torch.super import image as SI

    rungs = []

    def recording(attempts, verbose=True):
        return oom.run_with_oom_fallback([(d, (lambda i, fn: lambda: (rungs.append(i), fn())[1])(i, fn))
                                          for i, (d, fn) in enumerate(attempts)], verbose)

    SI.run_with_oom_fallback = recording
    captured = io.StringIO()
    try:
        with contextlib.redirect_stdout(captured):
            yield rungs
    finally:
        SI.run_with_oom_fallback = oom.run_with_oom_fallback
        sys.stdout.write(captured.getvalue())
    if any(rungs) or "device OOM" in captured.getvalue():
        raise AssertionError(f"{what}: an out-of-memory rung was taken (upscaler rungs {rungs}; "
                             f"{captured.getvalue().strip()!r})")


def batch_times(fn, n: int):
    """Seconds of each of n calls of fn, each synchronised; and the last result."""
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, y


def rdb_forms(params, x, cfg):
    """The dense block's two forms on the same tree and input, in turns
    (grouped, concat, concat, grouped): the median ms of SUPER_FORM_BATCHES
    batches of each turn. `forward` runs whichever `rrdbnet._rdb` names."""
    import statistics

    from maua_tpu_torch.super.models import rrdbnet

    grouped = rrdbnet._rdb
    out = {"grouped": [], "concat": []}
    try:
        for form in ("grouped", "concat", "concat", "grouped"):
            rrdbnet._rdb = grouped if form == "grouped" else rrdbnet._rdb_concat
            rrdbnet.forward(params, x, cfg)
            out[form].append(statistics.median(batch_times(lambda: rrdbnet.forward(params, x, cfg),
                                                           SUPER_FORM_BATCHES)[0]) * 1e3)
    finally:
        rrdbnet._rdb = grouped
    return out


def run_super():
    """RealESRGAN-x4plus, 8 frames 256^2 -> 1024^2: f32 through the Upscaler
    (cuDNN TF32, the default) and bf16 through `rrdbnet.forward` on a bf16
    tree, as bench_super.py times it: img/s over SUPER_TIMED batches, peak
    memory, one batch under torch.profiler, beside the operations bound;
    the dense block's grouped and concat forms in turns; then each registry
    kind once at full width."""
    import statistics

    import torch

    from maua_tpu_torch.super import image as SI
    from maua_tpu_torch.super.models import rrdbnet

    tf32 = _default_tf32()
    x = torch.rand((SUPER_BATCH, SUPER_SIZE, SUPER_SIZE, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                   device="cuda")
    f32 = SI.Upscaler("RealESRGAN-x4plus", device="cuda", seed=0)
    macs = rrdb_macs(f32.cfg, SUPER_SIZE, SUPER_SIZE) * SUPER_BATCH
    out = {"macs_per_image": macs // SUPER_BATCH, **tf32}
    bf16_cfg = rrdbnet.RRDBConfig(dtype="bfloat16")
    bf16_params = rrdbnet.prepare(f32.params, bf16_cfg)
    x_nchw = x.permute(0, 3, 1, 2)
    with first_rungs_only("super"), torch.no_grad():
        for dtype, batch, peak in (("float32", lambda: f32(x), TF32_FLOPS),
                                   ("bfloat16", lambda: rrdbnet.forward(bf16_params, x_nchw, bf16_cfg), BF16_FLOPS)):
            for _ in range(2):
                batch()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, y = batch_times(batch, SUPER_TIMED)
            want = (SUPER_BATCH, 4 * SUPER_SIZE, 4 * SUPER_SIZE, 3)
            if dtype == "bfloat16":
                y = y.permute(0, 2, 3, 1)
            if tuple(y.shape) != want or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"super {dtype}: {tuple(y.shape)}, want finite {want}")
            ms = statistics.median(times) * 1e3
            bound_ms = 2 * macs / peak * 1e3
            out[dtype] = {"img_per_s": SUPER_BATCH / (ms / 1e3), "batch_ms": ms,
                          "batch_ms_all": [t * 1e3 for t in times],
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "bound_ms": bound_ms,
                          "bound_by": "operations", "bound_share": bound_ms / ms,
                          "profile": profile_batch(batch, "conv")}
            if dtype == "float32":
                out[dtype]["f32_cuda_core_bound_ms"] = 2 * macs / F32_FLOPS * 1e3
            torch.cuda.empty_cache()
        out["rdb_forms"] = {"float32": rdb_forms(f32._run_params, x_nchw, f32.cfg),
                            "bfloat16": rdb_forms(bf16_params, x_nchw, bf16_cfg)}
        del f32, bf16_params
        torch.cuda.empty_cache()
        kinds = {}
        gen = torch.Generator(device="cuda").manual_seed(2)
        for name, size in SUPER_KINDS:
            up = SI.Upscaler(name, device="cuda", seed=0)
            t0 = time.perf_counter()
            y = up(torch.rand((1, *size, 3), generator=gen, device="cuda"))
            torch.cuda.synchronize()
            want = (1, size[0] * up.scale, size[1] * up.scale, 3)
            if tuple(y.shape) != want or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"super {name}: {tuple(y.shape)}, want finite {want}")
            kinds[name] = {"kind": up.kind, "input": list(size), "output": list(y.shape),
                           "seconds": time.perf_counter() - t0}
    out["kinds"] = kinds
    return out


def super_card_vs_cpu():
    """Every registry kind but latent-diffusion at full width, the same random
    weights on the card and on the CPU, f32 with TF32 off, a 64^2 input:
    PSNR (peak 1) of the upscaled images."""
    import numpy as np
    import torch

    from maua_tpu_torch.super import image as SI

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    out = {}
    with first_rungs_only("super_reference"):
        for name in SUPER_REFERENCE:
            card = SI.Upscaler(name, device="cuda", seed=0)
            host = SI.Upscaler(name, device="cpu", params=tree_map(lambda t: t.cpu(), card.params))
            a = card(img).cpu().numpy().astype(np.float64)
            t0 = time.perf_counter()
            b = host(img).numpy().astype(np.float64)
            psnr = 10 * math.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))
            out[name] = {"kind": card.kind, "psnr_db": psnr, "max_abs_diff": float(np.abs(a - b).max()),
                         "cpu_seconds": time.perf_counter() - t0}
            if psnr < 40.0:
                raise AssertionError(f"super {name} card vs CPU PSNR {psnr:.2f} dB < 40 dB")
    return out


def run_super_load(tmp: str):
    """A basicsr .pth (params_ema) of RealESRGAN-x4plus, a realesrgan SRVGG
    .pth (params), an official SwinIR-M .pth and a waifu2x .json, written
    from seed-1 weights into a temporary MODELZOO: the Upscaler loads each
    tensor for tensor, and upscales a 64^2 image to the source's bytes
    (with cuDNN's deterministic algorithms)."""
    import io
    import json

    import torch

    from maua_tpu_torch import utility
    from maua_tpu_torch.super import image as SI

    _default_tf32()
    zoo = os.path.join(tmp, "modelzoo")
    img = torch.rand((1, 64, 64, 3), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    out = {}
    saved = utility.MODELZOO
    utility.MODELZOO = zoo
    try:
        with first_rungs_only("super_load"):
            for name in SUPER_LOAD:
                kind, cfg = SI.MODEL_REGISTRY[name]
                src = SI._INIT_FNS[kind](torch.Generator(device="cuda").manual_seed(1), cfg)
                path = os.path.join(zoo, SI._CHECKPOINT_FILES[name])
                os.makedirs(os.path.dirname(path), exist_ok=True)
                if kind == "upconv7":
                    with open(path, "w") as f:
                        json.dump(upconv7_json(src), f)
                else:
                    sd = {"rrdb": lambda: {"params_ema": rrdb_state_dict(src)},
                          "srvgg": lambda: {"params": srvgg_state_dict(src)},
                          "swinir": lambda: swinir_state_dict(src, cfg)}[kind]()
                    torch.save(sd, path)
                log = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    loaded = SI.Upscaler(name, device="cuda")
                load_s = time.perf_counter() - t0
                if log.getvalue():
                    raise AssertionError(f"super_load {name}: {log.getvalue().strip()}")
                n = assert_trees_equal(loaded.params, src, name)
                # deterministic algorithms: cuDNN's transposed convs may otherwise sum with atomics
                with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=True):
                    same = torch.equal(loaded(img), SI.Upscaler(name, device="cuda", params=src)(img))
                if not same:
                    raise AssertionError(f"super_load {name}: the loaded model's image differs from the source's")
                out[name] = {"file": os.path.basename(path), "bytes": os.path.getsize(path), "tensors_equal": n,
                             "load_seconds": load_s, "same_image": same}
    finally:
        utility.MODELZOO = saved
    return out


SUPER_VIDEO_FRAMES = 24


def run_super_video(tmp: str):
    """A synthetic 24-frame 256^2 clip (a moving gradient with noise, seed 5),
    upscaled with RealESRGAN-x4plus and interpolated with RIFE at factors 2
    and 4 through the video entry points and the writer this machine has (ffmpeg, else
    OpenCV), each file read back with OpenCV: 24 frames of 1024^2, and
    (T - 1) * factor + 1 frames of 256^2 at fps * factor."""
    import numpy as np

    from maua_tpu_torch.ops.video import ffmpeg_available, read_video, write_video
    from maua_tpu_torch.super.video import interpolate_video, upscale_video

    _default_tf32()
    rs = np.random.RandomState(5)
    y, x = np.mgrid[0:SUPER_SIZE, 0:SUPER_SIZE] / SUPER_SIZE
    clip = np.stack([np.stack([np.sin(8 * x + t / 4) * 0.5 + 0.5, y, np.cos(6 * y - t / 3) * 0.5 + 0.5], -1)
                     for t in range(SUPER_VIDEO_FRAMES)])
    clip = np.clip(clip + 0.03 * rs.randn(*clip.shape), 0, 1).astype(np.float32)
    folder = os.path.join(tmp, "super_video")
    src = os.path.join(folder, "clip.mp4")
    write_video(clip, src, fps=FPS, value_range=(0, 1))
    out = {"writer": "ffmpeg" if ffmpeg_available() else "cv2"}
    with first_rungs_only("super_video"):
        runs = [("upscale", lambda: upscale_video(src, os.path.join(folder, "up.mp4"), device="cuda"),
                 SUPER_VIDEO_FRAMES, 4 * SUPER_SIZE, FPS)]
        for factor in (2, 4):
            runs.append((f"rife_x{factor}", (lambda f: lambda: interpolate_video(
                src, os.path.join(folder, f"x{f}.mp4"), factor=f, device="cuda"))(factor),
                (SUPER_VIDEO_FRAMES - 1) * factor + 1, SUPER_SIZE, FPS * factor))
        for name, fn, want_frames, want_size, want_fps in runs:
            t0 = time.perf_counter()
            path = fn()
            seconds = time.perf_counter() - t0
            frames, fps = read_video(path)
            if frames.shape != (want_frames, want_size, want_size, 3) or abs(fps - want_fps) > 0.01:
                raise AssertionError(f"super_video {name}: {path} reads back as {frames.shape} at {fps} fps, "
                                     f"want {want_frames} frames of {want_size}^2 at {want_fps}")
            out[name] = {"frames": frames.shape[0], "size": want_size, "fps": fps, "seconds": seconds,
                         "bytes": os.path.getsize(path)}
    return out


MULTIRES_STEPS = 20  # LMS steps of the sd_multires schedule (the 1024^2 tiles start at t 0.5: 10 of them)


@contextlib.contextmanager
def attention_cases_recorded():
    """Counts the attention kernel's calls by case: the dtype, the scale,
    and the size, strides and storage offset of q, k and v as the wrapper
    gets them (the UNet's and the VAE's calls go through the module's
    `flash_attention_fused`)."""
    import collections

    from maua_tpu_torch.kernels import attention as A

    cases = collections.Counter()
    real = A.flash_attention_fused

    def recording(q, k, v, scale=None):
        cases[(str(q.dtype).removeprefix("torch."), scale,
               *((tuple(t.shape), t.stride(), t.storage_offset()) for t in (q, k, v)))] += 1
        return real(q, k, v, scale)

    A.flash_attention_fused = recording
    try:
        yield cases
    finally:
        A.flash_attention_fused = real


def check_attention_cases(cases, what: str):
    """The attention kernel against its plain version at every recorded case,
    on random card tensors laid out as that case's q, k and v (the same
    sizes, strides and storage offsets), with `attention_tolerance`. The
    comparison launches do not count."""
    import torch

    from maua_tpu_torch.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for (dtype, scale, *layouts), n in sorted(cases.items(), key=lambda c: -c[1]):
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(off + sum((m - 1) * st for m, st in zip(size, stride)) + 1, generator=gen,
                               device="cuda").to(dt).as_strided(size, stride, off) for size, stride, off in layouts)
        got = A.flash_attention_fused(q, k, v, scale)
        ref = A.flash_attention_plain(q, k, v, scale)
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        row = {"q": list(q.shape), "kv": list(k.shape), "strides": [list(t.stride()) for t in (q, k, v)],
               "dtype": dtype, "launches": n, "max_abs_err": err}
        if got.shape != ref.shape or got.dtype != dt or not bool((diff <= attention_tolerance(ref, dt)).all()):
            raise AssertionError(f"{what}: attention disagrees with its plain version at {row}")
        rows.append(row)
    A.reset_launches()
    return rows


def run_sd_multires():
    """The reference's multi-size text to image through image_sample: SD 1.x at
    full width, random weights from seed 0, f32, 512^2 (MULTIRES_STEPS LMS
    steps) -> RealESRGAN-x4plus to 2048^2 -> lanczos to 1024^2 -> nine 512^2
    tiles denoised from t 0.5 in batches of 4, 4 and 1 -> restitched. The
    attention kernel's launches are reset just before and read just after:
    10 per UNet evaluation, one per encode and one per decode. Then the
    kernel is held against its plain version at each case the run gave it
    (the tile batches' shapes among them)."""
    import torch

    from maua_tpu_torch.diffusion.image import image_sample
    from maua_tpu_torch.kernels import attention as A

    tf32 = _default_tf32()
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    with first_rungs_only("sd_multires"), attention_cases_recorded() as cases:
        A.reset_launches()
        t0 = time.perf_counter()
        img = image_sample(text=SD_PROMPT, sizes=((512, 512), (1024, 1024)), skips=(0.0, 0.5),
                           timesteps=MULTIRES_STEPS, sampler="lms", cfg_scale=5.0,
                           super_res_model="RealESRGAN-x4plus", tile_size=512, stitch=True, max_batch=4,
                           device="cuda", seed=0, stage_times=stages,
                           verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = A.launches
    if tuple(img.shape) != (1, 1024, 1024, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"sd_multires: image {tuple(img.shape)}, want finite (1, 1024, 1024, 3)")
    if float(img.std()) < 1e-3:
        raise AssertionError("sd_multires: the image is constant")
    tile_steps = round(MULTIRES_STEPS * 0.5)
    want = 10 * MULTIRES_STEPS + 1 + 3 * (10 * (MULTIRES_STEPS - tile_steps) + 2)
    if launches != want or sum(cases.values()) != launches:
        raise AssertionError(f"sd_multires: flash attention launched {launches} times in {sum(cases.values())} "
                             f"calls, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    value_range = [float(img.min()), float(img.max())]
    del img
    torch.cuda.empty_cache()
    attention_cases = check_attention_cases(cases, "sd_multires")
    return {"image": [1, 1024, 1024, 3], "launches": launches, "stage_seconds": stages, "wall_seconds": wall,
            "peak_mem_gib": peak, "value_range": value_range, "oom_rungs": 0,
            "attention_cases": attention_cases,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention_cases), **tf32}


def run_writer(repo: str, tmp: str):
    """The FFMPEG renderer end to end through the normal entry point: 24
    frames (1 s of the synthetic mix at 24 fps) of the example patch at
    1024^2 into an mp4, by whichever writer this machine has (ffmpeg, else
    OpenCV), read back with OpenCV: 24 frames of 1024 x 1024."""
    import cv2
    import torch

    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.ops.video import ffmpeg_available

    wav, video = os.path.join(tmp, "one_second.wav"), os.path.join(tmp, "writer", "clip.mp4")
    synth_wav(wav, seconds=1.0)
    stages = {}
    E.reset_launches()
    path, _ = generate_audiovisual_from_patch(wav, None, example_patch(repo, "stylegan2.py"), renderer="ffmpeg",
                                              renderer_kwargs={"output_file": video}, fps=FPS, out_size=(1024, 1024),
                                              device="cuda", stylegan_kwargs={"seed": 0}, stage_times=stages)
    torch.cuda.synchronize()
    cap = cv2.VideoCapture(path)
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    count = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        count += 1
        if frame.shape != (1024, 1024, 3):
            raise AssertionError(f"writer: frame {count} reads back as {frame.shape}")
    cap.release()
    if count != FPS or size != (1024, 1024):
        raise AssertionError(f"writer: {path} reads back as {count} frames of {size}, want {FPS} of (1024, 1024)")
    return {"writer": "ffmpeg" if ffmpeg_available() else "cv2", "frames": count, "size": list(size),
            "bytes": os.path.getsize(path), "stage_seconds": stages, "epilogue_launches": E.launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    try:
        from maua_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the maua_tpu_torch package is missing beside this script ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2

    phases = None
    if sys.argv[1:2] == ["--ar-features-child"] and len(sys.argv) == 3:
        print(json.dumps(ar_features_child(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        phases = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--phases kernel,flrelu,attn,mel,kconv,e2e,sg3_e2e,ar_e2e,ar_features,"
              "ar_reference,gan_load,sd_load,writer,super_load,super_video,profile,sg3_profile,reference,"
              "sg3_reference,sd_e2e,sd_steps,sd_profile,sd_reference,super,super_reference,sd_multires,delivery]",
              file=sys.stderr)
        return 2

    def want(name):
        return phases is None or name in phases

    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", lambda: {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                             "count": torch.cuda.device_count()})

    def build_all():
        from concurrent.futures import ThreadPoolExecutor

        names = ("epilogue", "filtered_lrelu", "attention", "spectrogram", "kconv")
        with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all started together
            libs = list(pool.map(build.build, names))
        return {"libraries": [str(p) for p in libs], "ptxas": {n: build.PTXAS_REPORT.get(n, "") for n in names}}

    phase("build", build_all)
    results = {}
    for name, fn in (("kernel", check_epilogue), ("flrelu", check_flrelu), ("attn", check_attention),
                     ("mel", check_mel), ("kconv", check_kconv)):
        if want(name):
            results[name] = phase(name, fn)
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        wav, song = os.path.join(tmp, "mix.wav"), os.path.join(tmp, "song.wav")
        synth_wav(wav)
        synth_wav(song, seconds=SONG_SECONDS, seed=1, chords=True)
        for name, fn in (("e2e", lambda: run_e2e(wav, repo)), ("sg3_e2e", lambda: run_sg3_e2e(wav, repo)),
                         ("ar_e2e", lambda: run_ar_e2e(wav, tmp)), ("ar_features", lambda: run_ar_features(song)),
                         ("ar_reference", lambda: ar_card_vs_cpu(song)), ("gan_load", lambda: run_gan_load(wav, repo, tmp)),
                         ("sd_load", lambda: run_sd_load(tmp)), ("writer", lambda: run_writer(repo, tmp)),
                         ("super_load", lambda: run_super_load(tmp)), ("super_video", lambda: run_super_video(tmp))):
            if want(name):
                results[name] = phase(name, fn)
                torch.cuda.empty_cache()
    for name, fn in (("profile", profile_render_batch), ("sg3_profile", profile_sg3_render_batch),
                     ("reference", card_vs_cpu), ("sg3_reference", sg3_card_vs_cpu), ("sd_e2e", run_sd_e2e),
                     ("sd_steps", run_sd_steps), ("sd_profile", profile_sd_step), ("sd_reference", sd_card_vs_cpu),
                     ("super", run_super), ("super_reference", super_card_vs_cpu), ("sd_multires", run_sd_multires),
                     ("delivery", run_delivery)):
        if want(name):
            results[name] = phase(name, fn)
            torch.cuda.empty_cache()
    if phases is not None:
        return 0  # a partial run prints no record

    kernel, flrelu, attn, mel, kconv = (results[k] for k in ("kernel", "flrelu", "attn", "mel", "kconv"))
    mel_launches, mel_cases = results["ar_e2e"]["spectrogram_launches"], results["ar_e2e"]["mel_cases"]
    mel_main = mel["cases"][max(mel_cases, key=lambda c: mel_cases[c] * mel["cases"][c]["bound_ms"])]
    song_cases = results["ar_features"]["warm"]["mel_cases"]
    record = {"kernels": [{
        "name": "modconv_epilogue",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/epilogue.cu",
        "replaces": "maua_tpu/kernels/epilogue.py:112",
        "launches": results["e2e"]["launches"],
        "loaded_launches": results["gan_load"]["sg2_ada.pkl"]["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["frame_batch_ms"],
        "plain_ms": kernel["frame_batch_plain_ms"],
        "bound_ms": kernel["frame_batch_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "scope": f"the 17 launches of one 1024^2 StyleGAN2 frame batch of {BATCH}; loaded_launches: the e2e clip "
                 f"rendered from an ADA .pkl (gan_load)",
    }, {
        "name": "filtered_lrelu",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/filtered_lrelu.cu",
        "replaces": "maua_tpu/kernels/filtered_lrelu.py:361",
        "launches": results["sg3_e2e"]["launches"],
        "loaded_launches": results["gan_load"]["sg3_nvidia.pt"]["launches"],
        "max_abs_err": flrelu["max_abs_err"],
        "ms": flrelu["frame_batch_ms"],
        "plain_ms": flrelu["frame_batch_plain_ms"],
        "bound_ms": flrelu["frame_batch_bound_ms"],
        "bound_by": flrelu["bound_by"],
        "library_ms": None,
        "scope": f"the 13 launches of one 1024^2 StyleGAN3 frame batch of {BATCH} in bf16; loaded_launches: the e2e "
                 f"clip rendered from an NVIDIA-named .pt (gan_load)",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/attention.cu",
        "replaces": "maua_tpu/kernels/attention.py:85",
        "launches": results["sd_e2e"]["launches"],
        "loaded_launches": results["sd_load"]["loaded_launches"],
        "multires_launches": results["sd_multires"]["launches"],
        "multires_max_abs_err": results["sd_multires"]["attention_max_abs_err"],
        "max_abs_err": attn["max_abs_err"],
        "ms": attn["image_f32"]["ms"],
        "plain_ms": attn["image_f32"]["plain_ms"],
        "bound_ms": attn["image_f32"]["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": attn["image_f32"]["library_ms"],
        "bf16_max_abs_err": attn["max_abs_err_bf16"],
        **{f"bf16_{k}": attn["image_bf16"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "scope": f"the {10 * SD_STEPS + 1} launches of one 512^2 {SD_STEPS}-step SD 1.x image in f32 (sd_e2e's "
                 f"path, CUDA cores); bf16_*: the same launches in bf16 (the sd_steps path, tensor cores); "
                 f"loaded_launches: one {SD_LOAD_STEPS}-step image from a CompVis checkpoint (sd_load); "
                 f"multires_launches: one 512^2 -> 1024^2 image in nine tiles, {MULTIRES_STEPS} LMS steps "
                 f"(sd_multires), whose every case the kernel matches with multires_max_abs_err",
    }, {
        "name": "melspectrogram",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/spectrogram.cu",
        "replaces": "maua_tpu/kernels/spectrogram.py:113",
        "launches": mel_launches,
        "max_abs_err": mel["max_abs_err"],
        **{k: sum(n * mel["cases"][c][k] for c, n in mel_cases.items())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": mel_main["bound_by"],
        "song_launches": results["ar_features"]["warm"]["mel_launches"],
        **{f"song_{k}": sum(n * mel["cases"][c][k] for c, n in song_cases.items())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "scope": f"the {mel_launches} launches of one {SECONDS:g} s mel-patch video, each priced at its mel case "
                 f"({', '.join(f'{n} x {c}' for c, n in mel_cases.items())}); song_*: the launches of the feature "
                 f"stage over a {SONG_SECONDS:g} s song (ar_features), priced alike "
                 f"({', '.join(f'{n} x {c}' for c, n in song_cases.items())}); library: torch.stft and the mel matmul",
    }, {
        "name": "kconv3x3",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/kconv.cu",
        "replaces": "maua_tpu/kernels/kconv.py:155",
        "launches": 0,
        "max_abs_err": kconv["max_abs_err"],
        **{k: kconv[f"sg3_tail_bf16_{k}"] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": kconv["sg3_tail_bf16_bound_by"],
        **{f"f32_{k}": kconv[f"f32_{k}"] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "bound_by")},
        "scope": f"no path: nothing in maua_tpu or in the port calls it (as with its TPU kernel); times are the "
                 f"three last 3x3 layers of a 1024^2 StyleGAN3 frame batch of {BATCH} in bf16; f32_*: the sum over "
                 f"the f32 cases at batch 1 (the same three layers and RRDB's five growth convs at 512^2, on the "
                 f"CUDA cores); library: F.conv2d (f32 with TF32 off)",
    }]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

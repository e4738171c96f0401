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
   8 with the affines synthesis passes and in f32 at batch 1, plus its
   option cases; CUDA event times beside the bound and the plain version.
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

`--phases a,b` runs only the named phases after device and build (for
iterating on one kernel); with no arguments every phase runs. Any
failure exits non-zero. It needs one CUDA card and writes only to a
temporary directory and to the kernel build directory. The last two
lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

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
FPS = 24
SECONDS = 3.0
SR = 22050
BATCH = 8


def phase(name, fn):
    t0 = time.perf_counter()
    out = fn()
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **(out or {})}), flush=True)
    return out


def synth_wav(path: str, seconds: float = SECONDS, sr: int = SR, seed: int = 0) -> None:
    """A kick / snare / bass / tone mix, made from a seed."""
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
    wavfile.write(path, sr, (y / np.abs(y).max() * 0.9).astype(np.float32))


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def flrelu_macs(b: int, c: int, h: int, w: int, up: int) -> int:
    """Multiply-adds of the direct separable polyphase form for one call:
    up-FIR along H (6 per tmp row sample at the input width), along W (6
    per tmp sample), down-FIR along W (12 per sample at the output width)
    and along H (12 per output sample)."""
    ht, wt, ho, wo = h * up, w * up, h * up // 2, w * up // 2
    return b * c * (ht * w * 6 + ht * wt * 6 + ht * wo * 12 + ho * wo * 12)


def flrelu_cases():
    """(label, B, C, H, W, up, up_f, down_f, dtype, pre, post) of the 13
    filtered-lrelu launches of one 1024^2 StyleGAN3 frame batch in bf16
    at batch 8, the same 13 in f32 at batch 1, then the option cases."""
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config, resample_plan

    cfg = SG3Config(dtype="bfloat16")
    _, _, _, _, sizes, channels = cfg.layer_plan()
    plan = resample_plan(cfg)
    cases = []
    for dtype, b in ((torch.bfloat16, BATCH), (torch.float32, 1)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for i, (up, _, up_f, down_f, _) in enumerate(plan):
            s = int(sizes[i])
            cases.append((f"L{i}-{tag}", b, int(channels[i + 1]), s, s, up, up_f, down_f, dtype, True, True))
    up, _, up_f, down_f, _ = plan[8]  # 276^2 -> 552^2, 128 channels
    for label, pre, post in (("no-affines", False, False), ("pre-only", True, False), ("post-only", False, True)):
        cases.append((label, BATCH, 128, 276, 276, up, up_f, down_f, torch.bfloat16, pre, post))
    for up in (2, 4):
        _, _, up_f, down_f, _ = next(p for p in plan if p[0] == up)
        cases.append((f"odd-up{up}", 3, 5, 37, 45, up, up_f, down_f, torch.float32, True, True))
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
        for label, b, c, h, w, up, up_f, down_f, dtype, pre, post in flrelu_cases():
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")

            x = (rnd(b, c, h, w) * 4).to(dtype)
            kw = {}
            if pre:
                kw = dict(pre_scale=torch.rand(b, c, generator=gen, device="cuda") + 0.5, pre_add=rnd(b, c) * 0.1)
            if post:
                kw["post_scale"] = torch.rand(b, c, generator=gen, device="cuda") + 0.5
            out = FL.filtered_lrelu(x, up_f, down_f, up, 2, **kw)
            ref = FL.filtered_lrelu_plain(x, up_f, down_f, up, 2, **kw)
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
            # read x once, write y (up^2 / 4 times x's size) once, and the per-plane scalars
            nbytes = x.numel() * x.element_size() * (1 + up * up // 4) + 4 * b * c * len(kw)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            macs = flrelu_macs(b, c, h, w, up)
            ops_ms = 2 * macs / F32_FLOPS * 1e3
            ms = cuda_time_ms(lambda: FL.filtered_lrelu(x, up_f, down_f, up, 2, **kw))
            plain_ms = cuda_time_ms(lambda: FL.filtered_lrelu_plain(x, up_f, down_f, up, 2, **kw), iters=3)
            bound_ms = max(bytes_ms, ops_ms)
            rows.append({"case": label, "shape": [b, c, h, w], "up": up, "dtype": str(dtype).split(".")[-1],
                         "affines": sorted(kw), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                         "bytes": nbytes, "macs": macs})
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


def render_video(wav: str, repo: str, example: str, kernel_module, per_batch: int, stylegan_kwargs: dict):
    """Render the example patch over the wav on the card through the
    normal entry point; the kernel's launch count is reset just before
    and must be `per_batch` times the render batches just after."""
    import numpy as np
    import torch

    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch

    patch_file = os.path.join(repo, "maua_tpu_torch", "audiovisual", "patches", "examples", example)
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    kernel_module.reset_launches()
    video, _ = generate_audiovisual_from_patch(
        wav, None, patch_file, renderer="memmap", renderer_kwargs={"batch_size": BATCH}, fps=FPS,
        out_size=(1024, 1024), device="cuda", stylegan_kwargs=stylegan_kwargs, stage_times=stages)
    launches = kernel_module.launches
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
    return {"frames": list(video.shape), "render_batches": batches, "launches": launches,
            "stage_seconds": stages, "render_fps": n_frames / stages["render"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_e2e(wav: str, repo: str):
    from maua_tpu_torch.kernels import epilogue as E

    return render_video(wav, repo, "stylegan2.py", E, 17, {"seed": 0})


def run_sg3_e2e(wav: str, repo: str):
    from maua_tpu_torch.gan.stylegan3 import SG3Config
    from maua_tpu_torch.kernels import filtered_lrelu as FL

    cfg = SG3Config(img_resolution=1024, dtype="bfloat16")
    return render_video(wav, repo, "stylegan3.py", FL, cfg.num_layers - 1, {"cfg": cfg, "seed": 0})


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
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        phases = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--phases kernel,flrelu,attn,e2e,sg3_e2e,profile,sg3_profile,reference,"
              "sg3_reference,sd_e2e,sd_steps,sd_profile,sd_reference]", file=sys.stderr)
        return 2

    def want(name):
        return phases is None or name in phases

    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", lambda: {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                             "count": torch.cuda.device_count()})

    def build_all():
        from concurrent.futures import ThreadPoolExecutor

        names = ("epilogue", "filtered_lrelu", "attention")
        with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all started together
            libs = list(pool.map(build.build, names))
        return {"libraries": [str(p) for p in libs], "ptxas": {n: build.PTXAS_REPORT.get(n, "") for n in names}}

    phase("build", build_all)
    results = {}
    for name, fn in (("kernel", check_epilogue), ("flrelu", check_flrelu), ("attn", check_attention)):
        if want(name):
            results[name] = phase(name, fn)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "mix.wav")
        synth_wav(wav)
        for name, fn in (("e2e", run_e2e), ("sg3_e2e", run_sg3_e2e)):
            if want(name):
                results[name] = phase(name, lambda: fn(wav, repo))
                torch.cuda.empty_cache()
    for name, fn in (("profile", profile_render_batch), ("sg3_profile", profile_sg3_render_batch),
                     ("reference", card_vs_cpu), ("sg3_reference", sg3_card_vs_cpu), ("sd_e2e", run_sd_e2e),
                     ("sd_steps", run_sd_steps), ("sd_profile", profile_sd_step), ("sd_reference", sd_card_vs_cpu)):
        if want(name):
            results[name] = phase(name, fn)
            torch.cuda.empty_cache()
    if phases is not None:
        return 0  # a partial run prints no record

    kernel, flrelu, attn = results["kernel"], results["flrelu"], results["attn"]
    record = {"kernels": [{
        "name": "modconv_epilogue",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/epilogue.cu",
        "replaces": "maua_tpu/kernels/epilogue.py:112",
        "launches": results["e2e"]["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["frame_batch_ms"],
        "plain_ms": kernel["frame_batch_plain_ms"],
        "bound_ms": kernel["frame_batch_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "scope": f"the 17 launches of one 1024^2 StyleGAN2 frame batch of {BATCH}",
    }, {
        "name": "filtered_lrelu",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/filtered_lrelu.cu",
        "replaces": "maua_tpu/kernels/filtered_lrelu.py:361",
        "launches": results["sg3_e2e"]["launches"],
        "max_abs_err": flrelu["max_abs_err"],
        "ms": flrelu["frame_batch_ms"],
        "plain_ms": flrelu["frame_batch_plain_ms"],
        "bound_ms": flrelu["frame_batch_bound_ms"],
        "bound_by": flrelu["bound_by"],
        "library_ms": None,
        "scope": f"the 13 launches of one 1024^2 StyleGAN3 frame batch of {BATCH} in bf16",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/attention.cu",
        "replaces": "maua_tpu/kernels/attention.py:85",
        "launches": results["sd_e2e"]["launches"],
        "max_abs_err": attn["max_abs_err"],
        "ms": attn["image_f32"]["ms"],
        "plain_ms": attn["image_f32"]["plain_ms"],
        "bound_ms": attn["image_f32"]["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": attn["image_f32"]["library_ms"],
        "scope": f"the {10 * SD_STEPS + 1} launches of one 512^2 {SD_STEPS}-step SD 1.x image in f32",
    }]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

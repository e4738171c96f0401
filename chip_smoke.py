#!/usr/bin/env python3
"""Drive the PyTorch port (maua_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc builds every CUDA kernel of the paths from the six sources
   under maua_tpu_torch/csrc into maua_tpu_torch/_build, all at once, and
   g++ the host kernels of maua_tpu_torch/native.py beside them.
3. kernel: the modulated-conv epilogue kernel against its plain PyTorch
   version at every epilogue shape of a 1024^2 StyleGAN2 frame batch of
   8, in each layer's dtype, on the plain route and on the space-to-depth
   route's cell grids (b512 as 256 channels at 256^2, b1024 as 128 at
   512^2, 4 noise groups), plus its option cases at one shape; CUDA event
   times beside the memory-bytes bound and the plain version.
4. flrelu: the filtered-lrelu kernel against its plain PyTorch version
   at the 13 shapes of a 1024^2 StyleGAN3 frame batch, in bf16 at batch
   8 with the affines and the centre crops synthesis passes and in f32 at
   batch 1, plus its option cases; CUDA event times beside the bound (of
   the kept outputs) and the plain version.
5. e2e: the audio-reactive video (ExampleSG2Patch, memmap renderer) of a
   3 s synthetic wav made from a seed, at 24 fps, through a random-init
   full-width StyleGAN2 (config-f, 1024^2, bf16 top resolutions), with
   the epilogue's launch count reset just before and read just after;
   the facade renders b512 and b1024 on space-to-depth grids
   (gan/fast_synthesis.py), whose launches are counted by cell shape.
   Then the same clip to 1920 x 1080 (the output resize takes the plain
   route): 17 launches a batch, none on cells, b512 and b1024 at their
   plain shapes.
6. sg3_e2e: the same wav through ExampleSG3Patch and a random-init
   full-width StyleGAN3 (config T, 1024^2, bf16 trunk), with the
   filtered-lrelu launch count reset just before and read just after.
7. profile, sg3_profile: one render batch of each net under
   torch.profiler, device time by kernel and the device's idle share.
8. reference, sg3_reference: one frame of each net in f32 with TF32 off
   (StyleGAN2 on the facade's s2d route and on the plain route),
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
   at n_fft 2048, hop 512 with 128 mels and hop 1024 with 512 and 128 mels,
   on 3 s and 180 s signals and a batch of 4; CUDA event times beside the bound,
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
27. umx (after super_video): the openunmix-style separator at the full
   UMXConfig, random-init, over the 180 s song on the card (cold, warm),
   the stems' sum against the mixture's bins, card vs CPU stems over 5 s
   with TF32 off.
28. noise_patch: the noise-parameterization example patch over the 3 s
   wav at 1024^2, as e2e renders (its noise reaches the s2d tail).
29. gan_generate: `python -m maua_tpu_torch gan generate` at 1024^2, two
   PNGs by random, polarity and jacnorm sampling, and two StyleGAN3 frames
   resized to 1920 x 1080.
30. fast (before profile): the s2d route at config-f 1024^2: plan seconds
   (the facade's first s2d call), the epilogue launches of one batch on
   each route, multiply-adds per frame beside the plain convs', one f32
   frame s2d vs plain and card vs CPU (TF32 off), and the A/B that decides
   the facade's route: s2d and plain batches of 8 in turns (P N N P ...),
   fps and one profiled batch of each; then the same A/B for an f32
   facade, at batch 1 and for a 512^2 net.
31. sg3_resize (after sd_multires): the StyleGAN3 facade (config T, 1024^2)
   rendering to 1920 x 1080; the resize card vs CPU; one f32 256^2 frame
   resized to 480 x 270, card vs CPU.
32. realtime: the realtime viewer's random walk through the StyleGAN2
   facade into a callback, 48 frames, fps.
33. ss_mir (after gan_generate): the self-supervised music information
   (eight features at hop 1024, a Laplacian segmentation of each at k 2..16,
   the tempo) over the 180 s song in a fresh process, cold and warm, with
   the mel launches by MEL_SHAPES case (3 a call); then the song's first
   20 s on the card and on the CPU, TF32 off: features, tempo, labels up
   to relabelling, the eigen-gap at each k.
34. ss_e2e: `selfsupervised.sample.generate` over the 3 s wav at config-f
   1024^2 (seed-0 weights, bf16 top resolutions, batch 8, every layer's
   noise from the patch): 153 epilogue launches, 36 on s2d cells; stage
   seconds, the noise windows' and the synthesis' device ms a batch, fps,
   peak memory, the patch's subpatches, 72 frames read back.
35. ss_reference: one batch of a patch's latents and 17 noise windows on
   the card and on the CPU from the same draws, f32 with TF32 off; one
   256^2 frame with its patch's noise, PSNR.
36. interactive: `generate_interactive` over an 8 s wav with a scripted
   input and a manual layout whose last section is twice its patch, at
   config-f 1024^2 to 512^2 (the plain route): 192 frames read back, 24
   batches, 408 epilogue launches, none on cells.
37. av_correlation: the video descriptors of the ss_e2e clip's first 24
   frames as read back against the wav's audio features of that second,
   every metric of the battery; its first 6 frames on the card and on the
   CPU, metric by metric.
38. sd_guided (after av_correlation): image_sample at 512^2 with CLIP (16
   cutouts, ViT-B/32 from seed 0) and colour-match guidance, cfg 5, 5 LMS
   steps (cut from 50), f32: stage seconds, seconds per guided step, peak
   memory, 56 attention launches (10 UNet + 1 guidance decode a step, the
   final decode), 55 of them under autograd, each such case's dq, dk, dv
   against the plain version's; one guided evaluation at 256^2 card vs CPU
   (output and gradient PSNR).
39. sd_paths: the image-conditioned SD at 512^2 (5 steps), GuidedDiffusion
   at 256^2 with CLIP guidance on the "fast" route (5 DDIM steps, 3 PLMS
   steps), LatentDiffusion PLMS at 512^2 (4 steps) with CLIP guidance
   through the decoder: seconds and attention launches of each (5 under
   autograd, the latent path's guidance decodes); every case the kernel
   met there held against the plain version, forward and (under
   autograd) dq, dk, dv.
40. sd_glide (after sd_paths): GLIDE at its published sizes (64^2 base with
   cfg 3, 256^2 upsampler, 5 DDIM steps a stage) and GLID3XL (SD 1.x UNet
   and VAE with a 768-wide BERT, 256^2, 5 PLMS steps) through
   image_sample: stage seconds, 120 and 31 attention launches; each GLIDE
   UNet once card vs CPU (PSNR); BERTEmbedder at 1280 x 32 layers over 77
   tokens, seconds and card vs CPU.
41. sd_animation: interpolate_latents (8 frames, renoised), klmc2_animation
   (8 frames, forward-mode Hessian-vector products through the kernel
   route), outpaint (512^2 onto 640^2) and loop_video (8 frames) through SD
   1.x at 512^2, 5 timesteps: seconds and launches of each; every case
   held against the plain version, forward-mode tangents included.
42. sd_video: video_sample on Farneback flow over a synthetic 4-frame 512^2
   clip (10 LMS timesteps, skip 0.7, first_skip 0.4) and loop_direct_sample
   over it (blend_every 0.1: 6 passes): flow seconds, seconds per frame,
   frames read back, launches; Horn-Schunck flow and a warp-and-blend card
   vs CPU.
43. flow_neural: spynet, pwc, liteflownet, unflow, raft and gma from
   synthetic checkpoints in their published layouts over a 4-frame 512^2
   pan: seconds per pair, mean flow, card vs CPU at 256^2; then
   video_sample on RAFT flow (10 LMS timesteps): seconds, attention
   launches, every case held against the plain version.
44. style: style transfer at 512^2, rgb + VGG19 + L-BFGS (10 iterations:
   seconds and loss evaluations per iteration) and VQGAN + Adam (5
   iterations: the decoder's (1, 1, 16384, 128) attention under autograd,
   dq, dk, dv); one loss gradient at 128^2 card vs CPU; peak memory.
45. style_video: the flow-consistent video style transfer at its defaults
   (256^2, 4 passes, 64 iterations a frame) over the 4-frame pan with RAFT
   flow: seconds per frame, flow seconds, the video read back.
46. epilogue_grad (after kernel): the epilogue's autograd route
   (`ModconvEpilogue`: the kernel forward, a recomputed f32 backward) at
   every epilogue shape of a 1024^2 StyleGAN2 frame batch of 8 (the plain
   route's layers, the s2d cells with pre_next), f32 and bf16: dz, dpost,
   dnoise, dbias and dpre_next against autograd of the plain version on the
   card, the backward's ms per batch beside its bound.
47. gan_langevin (after style_video): `gan generate --sampling langevin
   --langevin_critic "a red fox" --seeds 0-2` at 1024^2 (50 steps, seed-0
   StyleGAN2 and CLIP): the PNGs, 17 launches under autograd a step, each
   case's gradients; dE/dz through the kernel against the plain version at
   1024^2 (f32) and card vs CPU at 128^2, TF32 off; beside it dE/dz with the
   Function's backward on the plain forward (the backward alone), with every
   epilogue output one ulp off (forward rounding alone), and two wrong
   gradients the bar must catch (a launch with no grad_fn, dpost dropped).
48. style_zoo: style transfer at 512^2, 5 iterations each: the stylegan
   parameterization with adam (15 launches a decode under autograd), the
   caffe zoo's pgg-vgg19 with lbfgs and nin with avg pooling, nima_score of
   a result, ranger (a Lookahead over RAdam); the stylegan loss's gradient
   card vs CPU at 128^2.
49. nca: `python -m maua_tpu_torch nca run` trains at 128^2 (batch 4,
   rollouts of 32-63 steps) for 20 steps and renders 120 frames at 256^2,
   read back: seconds per step, each step's loss and state peak (maua_tpu's
   recipe lets the states grow until they overflow; a loss may go
   non-finite only where the states did); 2 steps at 128^2 card vs CPU on
   the same draws; 120 frames rendered from those params, all finite:
   render fps.
50. video_vit (after realtime): the video ViT's gram style transfer at
   width 128, 4 layers, 4 heads, patch 8, tubelet 2 over an 8-frame 256^2
   clip, 10 Adam iterations: seconds per iteration, peak memory.
51. optimizers: every one of the 104 registry names 5 steps on an (8, 6)
   and a (6,) parameter, card vs CPU (TF32 off) within 1e-5; beside each,
   how far one ulp of every gradient moves it on the CPU alone; the two
   shampoo names (one ulp moves them 3e-5 to 3.5e-4) within 1e-3, on nine
   draws of the problem.
52. gan_train (after nca): `python -m maua_tpu_torch gan train` at config-f
   1024^2, batch 4, f32 over 8 seed-made images: 5 steps at the default
   intervals (R1 at 0, path length at 0 and 4, the initial blur on), the one
   evaluation at the last step (64 images, the ResNet extractor), the best and
   final checkpoints; seconds a step by stage, peak memory, the epilogue's
   launches in all (272) and under autograd (119), one plain step profiled;
   the checkpoint round trip, and one step from it against one from the state
   in memory (deterministic kernels: equal).
53. gan_langevin_d: `gan generate --sampling langevin --langevin_critic
   discriminator` on an ADA .pkl with a D entry (config-f, seeds 0 and 1): two
   PNGs, seconds, 850 launches under autograd.
54. gan_train_reference (after optimizers): one train step card vs CPU at
   64^2 on the same draws (TF32 off, the card's convolutions on PyTorch's
   own CUDA kernels; cuDNN's readings beside it, unbarred), D and G
   gradients leaf by leaf; the
   kernel route against the plain route at 1024^2, beside it the plain route
   again and with every epilogue output one ulp off (sound readings the bar
   must pass; again under cuDNN's deterministic algorithms, unbarred); beside
   each, the detached (pre-repair) backward's reading and, at 1024^2, the
   noise input's gradient dropped, which the bar must reject. epilogue_grad
   also holds the double backward through the Function at every plain-route
   layer shape in f32 and bf16.
55. autoreg (after sd_finetune): text to image at ruDALL-E
   Malevich's transformer widths (1.31 B parameters, f32, TF32 off):
   prefill 127 text tokens, sample 1024 tokens for 4 images with the KV
   cache at top-k 64, decode them to 256^2 through the VQ decoder (its
   (4, 1, 1024, 512) mid attention on the kernel route, the case held
   against the plain version) and CLIP-rerank them to 2; stage seconds,
   tokens/s against the step's bytes bound, launches a step and the idle
   share of 8 profiled steps, peak memory. (The `ar_*` phases are the
   audio-reactive ones.)
56. autoreg_reference: the KV-cached and recompute samplers' tokens equal on
   the same draws (full width, 2 layers, a 16 x 16 grid); one oversampled
   decode to 1.5x the native columns; one RQ encode and decode at depth 4;
   transformer logits card vs CPU.
57. autoreg_video (after gan_langevin_d; with autoreg_finetune, gan_icgan
   and sd_finetune before gan_train_reference, as when its card step once
   moved): `python -m maua_tpu_torch
   autoregressive video` (3 keyframes, 1 interpolation round, guidance
   alpha 1.5), then both stages' cached and recompute fills, equal.
58. autoreg_finetune: `autoregressive finetune` at the CLI's config with
   and without --adam8bit; 4 int8-Adam finetune steps at full width.
59. gan_icgan: IC-GAN's BigGAN at 256^2 from a synthetic BigGAN-PyTorch
   state dict, batch 8, card vs CPU; the StyleGAN2 backbone's `generate`
   and 20 `icgan_clip` steps, the epilogue under autograd.
60. sd_finetune: SD 1.x finetuning at 512^2, batch 1: 3 steps with the EMA
   and a 5-step validation sample; the attention kernel under autograd, 10 a
   step; a resume from the saved state equal to the uninterrupted run, at a
   cut depth (the UNet's first two levels, one residual block each).
61. transport (after autoreg_reference): sliced histogram transport over a
   1024^2 image and every hist_match mode, card vs CPU.
62. codec (after writer): the e2e clip through the FFMPEG renderer with
   pix_fmt="dct" (the DCT frame codec: calibrated and encoded on the card,
   the packed bytes copied, the native C++ decoder on the host), batch 8,
   read back; every frame >= 40 dB against the card's own I420 of it, the
   card's stream against the CPU's encode of the same frames, the native
   decode against the numpy one; calibration, encode and decode times, bytes
   a frame against I420's; the renderer and the delivery alone, yuv420p
   against dct in turns (P N N P); the epilogue's launches.
63. native (after transport): the host kernels (g++, OpenMP) against their
   plain versions, quantile_device on the card past 2^24 elements against
   numpy, inverse_conv_device on the card, one emerging-conv round trip.
64. profiling: profiling.py on the card: a StageTimer stage, a
   torch.profiler trace, FlopCounterMode's count of a config-f frame against
   sg2_frame_flops, the codec render's model-FLOPs utilization.
65. serve (after autoreg_reference): `serve http` on port 0 with the GAN
   (config-f 1024^2, seed 0, max_batch 8, warmed up), diffusion (SD 1.x at
   512^2, max_batch 2, 8 euler steps) and upscale (RealESRGAN-x4plus)
   services: 24 GAN requests from 6 client threads and a z payload, two
   prompts in one batch and one alone, a 128^2 upscale, over HTTP; every PNG
   >= 40 dB from a direct call (and its bit-equal share), 17 epilogue
   launches a GAN batch, 10 attention launches an evaluation and 1 a decode
   (from /healthz), every case held against the plain versions; a StyleGAN3
   service batch, 13 filtered-lrelu launches; p50 / p95, occupancy, PNG time.
66. export: export_generator at config-f 1024^2, batch 8, replayed in a
   process that imports no model module (17 epilogue launches there, >= 40
   dB from the live service, ArtifactGANService over HTTP); export_diffusion
   at SD 1.x widths, batch 2, 2 steps: write seconds, size, 21 attention
   launches, frames against text2img_fn's; the artifact deleted.
67. parallel: pipeline_forward at ruDALL-E Malevich's widths (4 logical
   stages, 4 microbatches, f32, TF32 off) against forward within 1e-4 of the
   logits' peak; sharded_generate's tokens equal generate_tokens'; moe_apply_ep
   over a 4-way logical expert axis (8 experts, 1024 -> 4096, top-2, 8192
   tokens) against moe_apply; upscale_bulk_sharded on 8 frames against upscale.
68. int8 (after fast): the W8A8 plans. StyleGAN2 config-f 1024^2 (seed 0,
   bf16 top resolutions): make_fast_synthesis(int8=True) (calibration
   seconds), one batch of 8 with noise and motion on int8 cells: 17
   epilogue launches (4 on cells, 2 int8-out) and 4 conv_i8; StyleGAN3
   config T 1024^2 (bf16 trunk): quantize_sg3, one batch of 8: 13
   filtered-lrelu and 13 conv_i8 launches; any other count fails. Each
   route's PSNR against the f32 route; card vs CPU on one plan (f32, TF32
   off) >= 40 dB: StyleGAN2 at 1024^2, StyleGAN3 at 256^2 on the plan the
   background CPU reference calibrated; A/Bs in turns against the bf16 s2d
   route and the fused bf16 StyleGAN3 route, one profiled batch each; then
   conv_i8 bit-equal to its plain version at the 4 + 13 conv shapes of
   those batches and at all +-127 (Ci 512), timed beside its bound,
   torch._int_mm over F.unfold and cuDNN's bf16 conv; every epilogue case
   of the StyleGAN2 batch against its plain version (check_epilogue_cases:
   the int8-out ones within one code, and timed).
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


def in_temp_dir(fn):
    """A phase that writes files, run in a temporary directory of its own."""

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            return fn(tmp)

    return run


def release_memory():
    """Between phases: collect cyclic garbage (a facade's closures over itself keep its tensors alive) and
    return the cached blocks, so that every phase starts with the card's memory free."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase(name, fn):
    """Run one phase and print its JSON line: `phase_seconds` is the phase's wall time (a phase's own
    `seconds`, where it reports one, stands beside it), `cuda_allocated_gib` the device memory still
    allocated when it returns."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    elapsed = round(time.perf_counter() - t0, 3)
    print(json.dumps({"phase": name, "seconds": elapsed, **(out or {}), "phase_seconds": elapsed,
                      "cuda_allocated_gib": round(torch.cuda.memory_allocated() / 2**30, 3)}), flush=True)
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
    # the s2d route's cell grids (gan/fast_synthesis.py): each narrow block as 4 co channels at res / 2, the
    # noise in 4 phase groups (const noise shared; the noise patch gives b512.conv0 per-frame noise), conv1's
    # input style applied after conv0
    for res in s2d_blocks(cfg):
        for conv in (0, 1):
            cases.append((f"s2d-b{res}-conv{conv}", BATCH, 4 * cfg.channels(res), res // 2, res // 2,
                          cfg.compute_dtype(res), 1, 4, conv == 0, 256.0))
    cases.append(("s2d-b512-conv0-frame-noise", BATCH, 4 * cfg.channels(512), 256, 256, cfg.compute_dtype(512), BATCH,
                  4, True, 256.0))
    return cfg, cases


S2D_MIN_CHANNELS = 128  # the facade's build_fast_plan default: blocks narrower than this run on s2d grids


def s2d_blocks(cfg):
    """The blocks the StyleGAN2 facade runs on space-to-depth grids."""
    return [res for res in cfg.block_resolutions if res != 4 and cfg.channels(res) < S2D_MIN_CHANNELS]


def check_epilogue():
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    cfg, cases = epilogue_cases()
    num_conv = {res: cfg.block_num_conv(res) for res in cfg.block_resolutions}
    gen = torch.Generator(device="cuda").manual_seed(0)
    s2d = s2d_blocks(cfg)
    rows, batch_ms, batch_plain_ms, batch_bound_ms = [], 0.0, 0.0, 0.0
    s2d_ms, s2d_plain_ms, s2d_bound_ms = 0.0, 0.0, 0.0
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
        err = float((out.float() - ref.float()).abs().max())
        worst = max(worst, err)
        if not epilogue_agrees(out, ref):
            raise AssertionError(f"epilogue {label} disagrees with its plain version: max abs err {err}")
        nbytes = 2 * z.numel() * z.element_size() + (noise.numel() * 4 if noise is not None else 0) \
            + 4 * (post.numel() + bias.numel() + (pre_next.numel() if pre else 0))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 8 * z.numel() / F32_FLOPS) * 1e3
        ms = cuda_time_ms(lambda: E.modconv_epilogue(*args))
        plain_ms = cuda_time_ms(lambda: E.modconv_epilogue_plain(*args))
        rows.append({"case": label, "shape": [b, c, h, w], "dtype": str(dtype).split(".")[-1],
                     "noise": None if not nb else [nb, g], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": nbytes})
        # a frame batch on the plain route (b4..b1024) and on the s2d route (b4..b256, then the cell cases)
        if label.startswith("b") and label[1:].isdigit():
            reps = num_conv[int(label[1:])]
            batch_ms += reps * ms
            batch_plain_ms += reps * plain_ms
            batch_bound_ms += reps * bound_ms
            if int(label[1:]) not in s2d:
                s2d_ms, s2d_plain_ms, s2d_bound_ms = s2d_ms + reps * ms, s2d_plain_ms + reps * plain_ms, \
                    s2d_bound_ms + reps * bound_ms
        if label.startswith("s2d-") and not label.endswith("frame-noise"):
            s2d_ms, s2d_plain_ms, s2d_bound_ms = s2d_ms + ms, s2d_plain_ms + plain_ms, s2d_bound_ms + bound_ms
    E.reset_launches()  # the comparison launches do not count
    for r in rows:
        print(json.dumps({"epilogue": r}), flush=True)
    return {"max_abs_err": worst, "frame_batch_ms": batch_ms, "frame_batch_plain_ms": batch_plain_ms,
            "frame_batch_bound_ms": batch_bound_ms, "s2d_frame_batch_ms": s2d_ms,
            "s2d_frame_batch_plain_ms": s2d_plain_ms, "s2d_frame_batch_bound_ms": s2d_bound_ms,
            "s2d_cells": {r["case"]: {k: r[k] for k in ("shape", "noise", "max_abs_err", "ms", "plain_ms", "bound_ms")}
                          for r in rows if r["case"].startswith("s2d-")}}


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


def flrelu_agrees(out, ref):
    """check_flrelu's bar for the kernel's output against its plain version's: (agrees, max abs err)."""
    import torch

    diff = (out.float() - ref.float()).abs()
    rtol = 2.0**-7 if ref.dtype == torch.bfloat16 else 0.0
    return bool((diff <= rtol * ref.float().abs() + 1e-4).all()), float(diff.max())


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
            ok, err = flrelu_agrees(out, ref)
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"flrelu {label} disagrees with its plain version: max abs err {err}")
            del ref, out
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
    ("3s-h1024-m128", (66150,), 1024, 128),  # the self-supervised MIR of the 3 s clip (onsets, mfcc, tempo)
    ("180s-h1024-m128", (3969000,), 1024, 128),  # the same of a song (ss_mir)
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
                 model_file=None, out_size=(1024, 1024)):
    """Render the patch over the wav on the card through the normal entry
    point (from `model_file` when given) at `out_size`; the kernel's launch
    count (and those of the modules in `counted`) is reset just before and
    read just after, and the kernel's must be `per_batch` times the render
    batches.
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
        out_size=out_size, device="cuda", stylegan_kwargs=stylegan_kwargs, stage_times=stages)
    launches = kernel_module.launches
    other = {f"{m.__name__.rsplit('.', 1)[-1]}_launches": m.launches for m in counted}
    n_frames = round(SECONDS * FPS)
    want = (n_frames, out_size[1], out_size[0], 3)
    if video.shape != want or video.dtype != np.uint8:
        raise AssertionError(f"frames {video.shape} {video.dtype}, want {want} uint8")
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


@contextlib.contextmanager
def epilogue_cases_recorded():
    """Within the block, counts every epilogue launch on the card that the
    StyleGAN2 synthesis makes, by where it comes from ("cells":
    gan/fast_synthesis.py's s2d cells; "plain": gan/stylegan2.py's layers)
    and by case: (z's shape, its dtype, the noise's shape or None, whether
    a next style scale is applied, alpha, gain, clamp, whether the output is
    int8)."""
    import collections
    import inspect

    from maua_tpu_torch.gan import fast_synthesis as FS
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.kernels import epilogue as E

    signature = inspect.signature(E.modconv_epilogue)
    cases = {"cells": collections.Counter(), "plain": collections.Counter()}
    wrappers = {(FS, "cells"): FS.modconv_epilogue, (S2, "plain"): S2.modconv_epilogue}

    def recorder(wrapper, counted):
        def recording(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            if a["z"].is_cuda:
                counted[(tuple(a["z"].shape), str(a["z"].dtype).removeprefix("torch."),
                       None if a["noise"] is None else tuple(a["noise"].shape), a["pre_next"] is not None,
                       a["alpha"], a["gain"], a["clamp"], a["quant_out"])] += 1
            return wrapper(*args, **kwargs)
        return recording

    for (module, route), wrapper in wrappers.items():
        module.modconv_epilogue = recorder(wrapper, cases[route])
    try:
        yield cases
    finally:
        for (module, _), wrapper in wrappers.items():
            module.modconv_epilogue = wrapper


def epilogue_agrees(out, ref) -> bool:
    """The epilogue kernel's bar against its plain version: both compute in
    f32 and round once, so bf16 storage allows one bf16 ulp; int8 codes
    (quant_out) within one code."""
    import torch

    if ref.dtype == torch.int8:
        return out.shape == ref.shape and out.dtype == ref.dtype and int((out.int() - ref.int()).abs().max()) <= 1
    rtol = 2.0**-7 if ref.dtype == torch.bfloat16 else 1e-5
    return out.shape == ref.shape and out.dtype == ref.dtype and \
        bool(((out.float() - ref.float()).abs() <= rtol * ref.float().abs() + 1e-6).all())


def check_epilogue_cases(recorded, what: str):
    """The epilogue kernel against its plain version at every case that
    epilogue_cases_recorded counted (on either route), on random card tensors of that case's
    shapes and options, with epilogue_agrees: (rows, largest error). An
    int8-out case must also reach the clip (codes of +-127), and its row
    gains the share of codes that differ and its time (CUDA events) beside
    the bytes bound (z and the noise read once, the codes written once) and
    the plain version's time. The comparison launches do not count."""
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows, worst = [], 0.0
    cases = recorded["cells"] + recorded["plain"]
    for (shape, dtype, noise_shape, pre, alpha, gain, clamp, quant), n in sorted(cases.items(), key=lambda c: -c[1]):
        b, c = shape[:2]
        z = (rnd(*shape) * 4).to(getattr(torch, dtype))
        # an int8 output's pre_next carries the next conv's quantization scale, 127 / amax
        args = (z, rnd(b, c).abs() + 0.1, None if noise_shape is None else rnd(*noise_shape), rnd(c) * 0.1, alpha,
                gain, clamp, (rnd(b, c).abs() + 0.5) * (10.0 if quant else 1.0) if pre else None, quant)
        out, ref = E.modconv_epilogue(*args), E.modconv_epilogue_plain(*args)
        err = float((out.float() - ref.float()).abs().max())
        row = {"shape": list(shape), "dtype": dtype, "noise": noise_shape and list(noise_shape), "pre_next": pre,
               "gain": gain, "clamp": clamp, "int8_out": quant, "launches": n, "max_abs_err": err}
        if not epilogue_agrees(out, ref) or (quant and int(ref.abs().max()) != 127):
            raise AssertionError(f"{what}: the epilogue disagrees with its plain version at {row}")
        if quant:
            nbytes = z.numel() * z.element_size() + out.numel() + (0 if args[2] is None else 4 * args[2].numel())
            row.update(share_differing=float((out != ref).float().mean()),
                       ms=cuda_time_ms(lambda: E.modconv_epilogue(*args)),
                       plain_ms=cuda_time_ms(lambda: E.modconv_epilogue_plain(*args), iters=3),
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        del args, z, out, ref
        rows.append(row)
        worst = max(worst, err)
    E.reset_launches()
    return rows, worst


def render_s2d_video(wav: str, patch_file: str):
    """render_video of a StyleGAN2 patch (seed-0 weights), the epilogue's
    17 launches per batch, of which the s2d route's are counted by cell
    shape: each render batch must launch 4 (b512 and b1024, two convs each)."""
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.kernels import epilogue as E

    with epilogue_cases_recorded() as cases:
        _, stats = render_video(wav, patch_file, E, 17, {"seed": 0})
    cells, per_batch = cases["cells"], 2 * len(s2d_blocks(SG2Config()))
    if cells.total() != per_batch * stats["render_batches"]:
        raise AssertionError(f"{cells.total()} s2d epilogue launches, want {per_batch} x {stats['render_batches']}: "
                             f"the facade did not take the space-to-depth route")
    return {**stats, "s2d_launches": cells.total(), "s2d_cases": {str(c[:4]): n for c, n in sorted(cells.items(), key=str)}}


def plain_shape_counts(plain, cfg) -> dict:
    """Launches of the s2d blocks' layers at their plain shapes, by block:
    C channels at the block's resolution in rows (a stretched render widens
    the columns)."""
    return {f"b{res}": sum(n for c, n in plain.items() if c[0][1:3] == (cfg.channels(res), res))
            for res in s2d_blocks(cfg)}


def render_plain_video(wav: str, patch_file: str):
    """render_video of a StyleGAN2 patch to 1920 x 1080: the output resize
    keeps the facade on the plain route (stretched at layer 0: b512 at
    512 x 1024, b1024 at 1024 x 2048), so each render batch launches the
    epilogue 17 times, none of them on cells, twice at each plain shape of
    b512 and b1024."""
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.kernels import epilogue as E

    with epilogue_cases_recorded() as cases:
        _, stats = render_video(wav, patch_file, E, 17, {"seed": 0}, out_size=(1920, 1080))
    counts = plain_shape_counts(cases["plain"], SG2Config())
    if cases["cells"] or any(n != 2 * stats["render_batches"] for n in counts.values()):
        raise AssertionError(f"the 1920 x 1080 render launched {cases['cells'].total()} epilogues on cells and {counts} at "
                             f"the plain b512 / b1024 shapes, want 0 and 2 x {stats['render_batches']} each")
    return {**stats, "plain_shape_launches": counts}


def run_e2e(wav: str, repo: str):
    patch_file = example_patch(repo, "stylegan2.py")
    return {**render_s2d_video(wav, patch_file), "plain_1920x1080": render_plain_video(wav, patch_file)}


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
    """One f32 StyleGAN2 frame at 1024^2 with noise and motion, TF32 off, on
    the card and on the CPU: through the facade (the s2d route) and through
    `synthesize` (the plain route, which renders with an output resize)."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.gan.wrappers import StyleGAN2, synthesize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = SG2Config(dtype="float32")
    card = StyleGAN2(cfg=cfg, device="cuda", seed=0)
    cpu = StyleGAN2(cfg=cfg, params=card.params, device="cpu")
    gen = torch.Generator().manual_seed(1)
    noise = torch.randn(1, 1, 64, 64, generator=gen)
    inputs = dict(translation=torch.tensor([[0.05, 0.0]]), zoom=torch.tensor([0.9]), rotation=torch.tensor([3.0]))

    def frame(model, route):
        dev = model.device
        ws = model.get_w_latents("7")
        kw = {k: v.to(dev) for k, v in inputs.items()}
        noises = model.make_noise_pyramid(noise.to(dev))
        if route == "s2d":
            img = model.synthesizer(ws, noises=noises, **kw)
        else:
            img = synthesize(model.params, ws, model.cfg, model.rcfg, noises=noises, **kw)
        return ((img + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy().astype(np.float64)

    out = {}
    for route in ("s2d", "plain"):
        a, b = frame(card, route), frame(cpu, route)
        mse = float(np.mean((a - b) ** 2))
        out[route] = {"psnr_db": 10 * math.log10(255.0**2 / max(mse, 1e-12)),
                      "max_abs_diff": float(np.abs(a - b).max())}
        if out[route]["psnr_db"] < 40.0:
            raise AssertionError(f"card vs CPU {route} frame PSNR {out[route]['psnr_db']:.2f} dB < 40 dB")
    return {**out["s2d"], "plain": out["plain"]}


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


def ada_d_state_dict(params, cfg) -> dict:
    """The port's discriminator parameter dict under NVIDIA's ADA names (`fromrgb` lives in the top
    block, b{res}.fromrgb)."""
    tree = {k: v for k, v in params.items() if k != "fromrgb"}
    top = f"b{cfg.img_resolution}"
    tree[top] = {"fromrgb": params["fromrgb"], **tree[top]}
    return ada_state_dict(tree)


def write_ada_pkl(path: str, sd: dict, d_sd: dict | None = None) -> None:
    """Write a state dict as stylegan2-ada-pytorch pickles its networks:
    every nn.Module reduces through torch_utils.persistence's
    `_reconstruct_persistent_obj(meta)`, meta a dnnlib.EasyDict whose
    `state` is the module's __dict__ (tensors in `_parameters`/`_buffers`,
    submodules in `_modules`). Stand-ins for those two modules exist only
    while pickling, so the loader has to read the file without them.
    `d_sd`, a discriminator's state dict (ada_d_state_dict), fills the `D`
    entry, which is None otherwise."""
    import pickle
    import types

    import torch

    class Node(torch.nn.Module):
        pass

    def modules(state_dict):
        root = Node()
        for key, val in state_dict.items():
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
        return root

    root = modules(sd)
    d_root = None if d_sd is None else modules(d_sd)

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
            Pickler(f, protocol=4).dump({"G": root, "D": d_root, "G_ema": root, "training_set_kwargs": None,
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


def vae_state_dict(vae, prefix: str = "") -> dict:
    """The port's AutoencoderKL parameters under CompVis / taming names (`{prefix}encoder.conv_in.weight`,
    ...; the inverse of diffusion/load.vae_params_from_compvis)."""
    sd = {}

    def put(name, p):  # conv {w, b}, norms {scale, bias}
        for k, n in (("w", "weight"), ("b", "bias"), ("scale", "weight"), ("bias", "bias")):
            if k in p:
                sd[f"{name}.{n}"] = p[k]

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

    v, enc, dec = prefix, vae["encoder"], vae["decoder"]
    put(f"{v}encoder.conv_in", enc["conv_in"])
    level, b = 0, 0
    for blk in enc["blocks"]:
        if "down" in blk:
            put(f"{v}encoder.down.{level}.downsample.conv", blk["down"])
            level, b = level + 1, 0
        else:
            vres(f"{v}encoder.down.{level}.block.{b}", blk["res"])
            b += 1
    vmid(f"{v}encoder.mid", enc["mid"])
    put(f"{v}encoder.norm_out", enc["norm_out"])
    put(f"{v}encoder.conv_out", enc["conv_out"])
    put(f"{v}quant_conv", enc["quant_conv"])
    put(f"{v}post_quant_conv", dec["post_quant_conv"])
    put(f"{v}decoder.conv_in", dec["conv_in"])
    vmid(f"{v}decoder.mid", dec["mid"])
    b = 0  # the decoder starts at the encoder's last level
    for blk in dec["blocks"]:
        if "up" in blk:
            put(f"{v}decoder.up.{level}.upsample.conv", blk["up"])
            level, b = level - 1, 0
        else:
            vres(f"{v}decoder.up.{level}.block.{b}", blk["res"])
            b += 1
    put(f"{v}decoder.norm_out", dec["norm_out"])
    put(f"{v}decoder.conv_out", dec["conv_out"])
    return sd


def taming_state_dict(vq_params) -> dict:
    """A taming VQGAN state dict of the port's VQ parameters (`autoregressive/vq.py`): the codebook as
    `quantize.embedding.weight`, the autoencoder under CompVis names."""
    return {"quantize.embedding.weight": vq_params["codebook"], **vae_state_dict(vq_params["vae"])}


def biggan_state_dict(params, cfg, sv0: bool = True, seed: int = 0) -> dict:
    """A BigGAN-PyTorch / ic_gan generator state dict of the port's BigGAN parameters (`gan/biggan.py`):
    every spectral-norm layer's `weight` is the folded weight times a drawn sigma, with its `u0` and, with
    `sv0`, that sigma (the inverse of biggan.params_from_torch); ccbn statistics as `stored_mean` /
    `stored_var`."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    sd = {}

    def sn(name, w, b=None):
        sigma = float(rs.uniform(0.5, 2.0))
        sd[f"{name}.weight"] = w * sigma
        sd[f"{name}.u0"] = torch.from_numpy(rs.randn(1, w.shape[0]).astype(np.float32))
        if sv0:
            sd[f"{name}.sv0"] = torch.tensor([sigma])
        if b is not None:
            sd[f"{name}.bias"] = b

    sn("linear", params["linear"]["w"], params["linear"]["b"])
    if "embed_features" in params:
        sn("embed_features", params["embed_features"]["w"])
    if "shared" in params:
        sd["shared.weight"] = params["shared"]
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}.0"
        for bn in ("bn1", "bn2"):
            sn(f"{pre}.{bn}.gain", blk[bn]["gain"]["w"])
            sn(f"{pre}.{bn}.bias", blk[bn]["bias"]["w"])
            sd[f"{pre}.{bn}.stored_mean"], sd[f"{pre}.{bn}.stored_var"] = blk[bn]["mean"], blk[bn]["var"]
        for c in ("conv1", "conv2", "conv_sc"):
            sn(f"{pre}.{c}", blk[c]["w"], blk[c].get("b"))
        if 4 * 2 ** (i + 1) == cfg.attention_res:
            for k in ("theta", "phi", "g", "o"):
                sn(f"blocks.{i}.1.{k}", params["attention"][k]["w"])
            sd[f"blocks.{i}.1.gamma"] = params["attention"]["gamma"].reshape(1)
    ob = params["output"]["bn"]
    sd["output_layer.0.gain"], sd["output_layer.0.bias"] = ob["scale"], ob["bias"]
    sd["output_layer.0.stored_mean"], sd["output_layer.0.stored_var"] = ob["mean"], ob["var"]
    sn("output_layer.2", params["output"]["conv"]["w"], params["output"]["conv"]["b"])
    return {k: v.detach().float().cpu().clone() for k, v in sd.items()}


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

    sd.update(vae_state_dict(vae, "first_stage_model."))

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


SD_LOAD_STEPS = 5  # LMS steps of the sd_load images (cut from 10 for time)


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


DELIVERY_FRAMES = 32  # frames per timed render: 4 batches of 8, 1 of 32 (cut from 96 to 64, then 32, for time)
DELIVERY_ROUTES = (("sync", "rgb24"), ("pipelined", "rgb24"), ("pipelined", "yuv420p"), ("sync", "yuv420p"))
DELIVERY_ROUNDS = 1  # timed renders of each route: 2 per round, in the order A B C D D C B A (cut from 2 rounds)


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
SUPER_TIMED = 3  # batches timed after two warm-ups; the median is reported (cut from 7 for time)
SUPER_FORM_BATCHES = 3  # batches of each turn of the dense-block forms' A/B (cut from 5 for time)
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


SUPER_VIDEO_FRAMES = 12  # cut from 24 for time


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


SD_GUIDED_STEPS = 5  # LMS steps of the sd_guided image (cut from the entry point's 50 to 10, then 5)
SD_GUIDED_CUTOUTS = 16
GRAD_BAR = 1e-4  # dq, dk, dv through the Function against autograd of the plain version: of their largest magnitude


def write_style_image(path: str, size: int = 512, seed: int = 3) -> None:
    """A colourful style image (two gradients and noise, from a seed) as a PNG."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([x, y, 1 - x * y], -1) * 0.8 + rs.rand(size, size, 3) * 0.2
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


@contextlib.contextmanager
def autograd_attention_cases():
    """Counts the kernel route's calls whose output autograd will differentiate through `FlashAttention`
    (its grad_fn is FlashAttention's backward), by case: the dtype, the scale, and the size, strides and
    storage offset of q, k and v (the module's `flash_attention`, which the dispatcher calls)."""
    import collections

    from maua_tpu_torch.kernels import attention as A

    cases = collections.Counter()
    real = A.flash_attention

    def recording(q, k, v, scale=None):
        out = real(q, k, v, scale)
        if type(out.grad_fn).__name__ == "FlashAttentionBackward":
            cases[(str(q.dtype).removeprefix("torch."), scale,
                   *((tuple(t.shape), t.stride(), t.storage_offset()) for t in (q, k, v)))] += 1
        return out

    A.flash_attention = recording
    try:
        yield cases
    finally:
        A.flash_attention = real


def check_attention_gradients(cases, what: str):
    """At every case the kernel route met under autograd: random card tensors laid out as that case's q, k
    and v and a random output gradient; dq, dk, dv through `FlashAttention` (the kernel forward, the
    recomputed backward) against autograd of the plain version on the card, f32 with TF32 off, each within
    GRAD_BAR of its largest magnitude; the output against the plain version with `attention_tolerance`.
    Then the backward's time (`bwd_ms`: the recompute of P and four matmuls, cuda_time_ms), its bound
    (the larger of 7 B H N D f32 words over 3.35 TB/s and 10 B H Nq Nk D f32 operations over 67 TFLOP/s)
    and the backward of scaled_dot_product_attention on the same tensors (`sdpa_bwd_ms`). The comparison
    launches do not count."""
    import torch
    import torch.nn.functional as F

    from maua_tpu_torch.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    with tf32_off():
        for (dtype, scale, *layouts), n in sorted(cases.items(), key=lambda c: -c[1]):
            dt = getattr(torch, dtype)
            q, k, v = (torch.randn(off + sum((m - 1) * st for m, st in zip(size, stride)) + 1, generator=gen,
                                   device="cuda").to(dt).as_strided(size, stride, off).requires_grad_(True)
                       for size, stride, off in layouts)
            out = A.FlashAttention.apply(q, k, v, scale)
            do = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
            got = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
            ref = A.flash_attention_plain(q, k, v, scale)
            want = torch.autograd.grad(ref, (q, k, v), do)
            errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, want)]
            row = {"q": list(q.shape), "kv": list(k.shape), "strides": [list(t.stride()) for t in (q, k, v)],
                   "dtype": dtype, "launches_under_autograd": n,
                   "max_abs_err": float((out.detach().float() - ref.detach().float()).abs().max()),
                   "grad_rel_err": dict(zip(("dq", "dk", "dv"), errs))}
            if (out.grad_fn is None or not bool(((out - ref).detach().abs() <= attention_tolerance(ref.detach(), dt)).all())
                    or max(errs) > GRAD_BAR):
                raise AssertionError(f"{what}: the kernel route's output or gradient disagrees at {row}")
            b, h, nq, d = q.shape
            nk = k.shape[2]
            sdpa = F.scaled_dot_product_attention(q, k, v, scale=scale)
            row.update(
                bwd_ms=cuda_time_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True), iters=5),
                sdpa_bwd_ms=cuda_time_ms(lambda: torch.autograd.grad(sdpa, (q, k, v), do, retain_graph=True),
                                         iters=5),
                bwd_bound_ms=max(7 * b * h * nq * d * 4 / HBM_BYTES_PER_S, 10 * b * h * nq * nk * d / F32_FLOPS) * 1e3)
            rows.append(row)
            del q, k, v, out, do, got, ref, want, sdpa
            torch.cuda.empty_cache()
    A.reset_launches()
    return rows


def guided_card_vs_cpu(style: str):
    """One guided denoiser evaluation (the CFG UNet, the decode, CLIP and colour guidance, the pull-back
    through decoder and UNet) at 256^2 on the card and on the CPU, f32 with TF32 off: the same random
    full-width SD 1.x and CLIP (seed 0, copied), x, sigma, text, style and cutout draws. PSNR of the
    guided output (peak: its range on the CPU) and of the gradient (peak: the CPU gradient's range)."""
    import numpy as np
    import torch

    from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
    from maua_tpu_torch.diffusion.wrappers import cfg_denoiser, guided_denoiser
    from maua_tpu_torch.grad import CLIPGrads, ColorMatchGrads
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.ops.cutouts import cutout_draws
    from maua_tpu_torch.perceptors.clip import CLIPPerceptor
    from maua_tpu_torch.prompt import StylePrompt, TextPrompt
    from maua_tpu_torch.utility import to_device

    kw = dict(sampler="lms", timesteps=SD_GUIDED_STEPS, cfg_scale=5.0, image_size=256)
    card = StableDiffusion(grad_modules=[CLIPGrads(scale=2000.0, n_cutouts=SD_GUIDED_CUTOUTS, device="cuda"),
                                         ColorMatchGrads(scale=500.0, device="cuda")], device="cuda", seed=0, **kw)
    clip_card = card.grad_modules[0].perceptor
    clip_host = CLIPPerceptor(vision_params=to_device(clip_card.vision_params, "cpu"),
                              text_params=to_device(clip_card.text_params, "cpu"), text_proj=clip_card.text_proj.cpu(),
                              device="cpu")
    host_grads = [CLIPGrads(perceptor=clip_host, scale=2000.0, n_cutouts=SD_GUIDED_CUTOUTS), ColorMatchGrads(scale=500.0)]
    host = StableDiffusion(grad_modules=host_grads, unet_params=to_device(card.unet_params, "cpu"),
                           vae_params=to_device(card.vae_params, "cpu"), text_params=to_device(card.text_params, "cpu"),
                           device="cpu", **kw)
    prompts = [TextPrompt(SD_PROMPT), StylePrompt(path=style, size=(256, 256))]
    draws = [tuple(d.cpu().numpy() for d in cutout_draws(torch.Generator().manual_seed(5), 256, 256, 224,
                                                          SD_GUIDED_CUTOUTS))]
    x = np.random.RandomState(1).randn(1, 4, 32, 32).astype(np.float32) * 8.0
    results = {}
    with tf32_off():
        for name, proc in (("card", card), ("cpu", host)):
            grads = []

            def cond_fn(*a, _proc=proc):
                g = _proc.cond_fn(*a)
                grads.append(g)
                return g

            for gm in proc.grad_modules:
                gm.set_targets(prompts)
            proc.grad_modules[0].draws = list(draws)
            cond, uncond = proc.conditioning(prompts)
            model = guided_denoiser(cfg_denoiser(proc.denoiser, cond, uncond, proc.cfg_scale), cond_fn)
            A.reset_launches()
            t0 = time.perf_counter()
            out = model(torch.from_numpy(x).to(proc.device), torch.full((1,), 8.0, device=proc.device))
            if proc.device.type == "cuda":
                torch.cuda.synchronize()
            results[name] = {"out": out.cpu().numpy(), "grad": grads[0].cpu().numpy(), "seconds":
                             time.perf_counter() - t0, "launches": A.launches}
    a, b = results["card"], results["cpu"]
    psnr_out = psnr_db(a["out"], b["out"], float(b["out"].max() - b["out"].min()))
    psnr_grad = psnr_db(a["grad"], b["grad"], float(b["grad"].max() - b["grad"].min()))
    if a["launches"] != 5 + 1 or b["launches"] != 0:  # at 32^2 latents only the UNet's level 1 takes the kernel
        raise AssertionError(f"guided evaluation: {a['launches']} card and {b['launches']} cpu launches, want 6, 0")
    if not (psnr_out >= 40.0 and psnr_grad >= 40.0):
        raise AssertionError(f"guided evaluation card vs CPU: output {psnr_out:.2f} dB, gradient {psnr_grad:.2f} dB")
    return {"resolution": 256, "psnr_db": psnr_out, "grad_psnr_db": psnr_grad,
            "max_abs_diff": float(np.abs(a["out"] - b["out"]).max()),
            "grad_max_abs_diff": float(np.abs(a["grad"] - b["grad"]).max()),
            "grad_abs_max": float(np.abs(b["grad"]).max()), "card_seconds": a["seconds"], "cpu_seconds": b["seconds"],
            "launches": a["launches"]}


def profile_guided_step(model, style: str):
    """One guided evaluation of sd_guided's model at 512^2 (x drawn from seed 2, sigma 8) under
    torch.profiler (profile_batch): device time by kernel, the attention kernel's share, idle share."""
    import torch

    from maua_tpu_torch.diffusion.wrappers import cfg_denoiser, guided_denoiser
    from maua_tpu_torch.prompt import StylePrompt, TextPrompt

    prompts = [TextPrompt(SD_PROMPT), StylePrompt(path=style, size=(512, 512))]
    for gm in model.grad_modules:
        gm.set_targets(prompts)
    cond, uncond = model.conditioning(prompts)
    fn = guided_denoiser(cfg_denoiser(model.denoiser, cond, uncond, model.cfg_scale), model.cond_fn)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, 4, 64, 64, generator=gen, device="cuda") * 8.0
    sigma = torch.full((1,), 8.0, device="cuda")
    return profile_batch(lambda: fn(x, sigma), "flash_attention")


def run_sd_guided(tmp: str):
    """Guided text to image through the entry point: image_sample at 512^2 with CLIP (16 cutouts) and colour
    match guidance towards a style image, cfg 5, LMS, SD_GUIDED_STEPS steps (cut from 50), a random-init
    full-width SD 1.x (seed 0), f32, twice: the first image warm-up (cold_seconds), the second measured. The
    attention kernel's launches are reset just before the second and read just after: per guided step the CFG UNet's 10 and the guidance decode's 1, and the final decode's 1. Every
    case the kernel route met under autograd is held (dq, dk, dv) against the plain version; then one
    guided evaluation at 256^2, card vs CPU."""
    import torch

    from maua_tpu_torch.diffusion.image import get_diffusion_model, image_sample
    from maua_tpu_torch.kernels import attention as A

    tf32 = _default_tf32()
    style = os.path.join(tmp, "style.png")
    write_style_image(style)
    model = get_diffusion_model("stable", timesteps=SD_GUIDED_STEPS, sampler="lms", cfg_scale=5.0,
                                clip_scale=2000.0, color_match_scale=500.0, device="cuda", seed=0)
    # a first image, not counted: its first guided evaluation loads the backward's kernels (cold_seconds)
    t0 = time.perf_counter()
    image_sample(text=SD_PROMPT, style=style, sizes=((512, 512),), diffusion=model, seed=0, verbose=False)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    with autograd_attention_cases() as grad_cases, attention_cases_recorded() as cases:
        A.reset_launches()
        t0 = time.perf_counter()
        img = image_sample(text=SD_PROMPT, style=style, sizes=((512, 512),), diffusion=model, seed=0,
                           stage_times=stages, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = A.launches
    if tuple(img.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(img).all()) or float(img.std()) < 1e-3:
        raise AssertionError(f"sd_guided: image {tuple(img.shape)}, want finite, non-constant (1, 512, 512, 3)")
    want = 11 * SD_GUIDED_STEPS + 1
    if launches != want or sum(cases.values()) != launches or sum(grad_cases.values()) != launches - 1:
        raise AssertionError(f"sd_guided: flash attention launched {launches} times ({sum(grad_cases.values())} "
                             f"under autograd), want {want} ({want - 1})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del img
    torch.cuda.empty_cache()
    profile = profile_guided_step(model, style)
    del model
    torch.cuda.empty_cache()
    gradient_cases = check_attention_gradients(grad_cases, "sd_guided")
    forward_cases = check_attention_cases(cases, "sd_guided")
    return {"image": [1, 512, 512, 3], "steps": SD_GUIDED_STEPS, "reduced": f"50 -> {SD_GUIDED_STEPS} LMS steps",
            "launches": launches, "launches_per_step": (launches - 1) / SD_GUIDED_STEPS,
            "launches_under_autograd": sum(grad_cases.values()), "stage_seconds": stages, "wall_seconds": wall,
            "cold_seconds": cold,
            "seconds_per_guided_step": stages["sampling"] / SD_GUIDED_STEPS, "peak_mem_gib": peak,
            "gradient_cases": gradient_cases,
            "grad_max_rel_err": max(max(r["grad_rel_err"].values()) for r in gradient_cases),
            "attention_bwd_ms_per_step": sum(r["launches_under_autograd"] * r["bwd_ms"] for r in gradient_cases)
            / SD_GUIDED_STEPS,
            "sdpa_bwd_ms_per_step": sum(r["launches_under_autograd"] * r["sdpa_bwd_ms"] for r in gradient_cases)
            / SD_GUIDED_STEPS, "profile": profile,
            "attention_max_abs_err": max(r["max_abs_err"] for r in forward_cases),
            "reference": guided_card_vs_cpu(style), **tf32}


def timed_path(fn):
    """fn() with the attention kernel's launches reset before and read after: (result, seconds, launches)."""
    import torch

    from maua_tpu_torch.kernels import attention as A

    A.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, A.launches


def check_image(img, shape, what: str):
    import torch

    if tuple(img.shape) != shape or not bool(torch.isfinite(img).all()) or float(img.std()) < 1e-3:
        raise AssertionError(f"{what}: image {tuple(img.shape)}, want finite, non-constant {shape}")


def run_sd_paths(tmp: str):
    """The other diffusion paths at full width, random weights from seed 0, f32, a few steps each:
    the image-conditioned SD 1.x at 512^2 (5 LMS steps; ViT-B/32 embeds the image prompt), GuidedDiffusion
    at 256^2 (OpenAI's unconditional UNet, CLIP guidance through the secondary model, "fast") with 5 DDIM
    steps and with 3 PLMS steps (4 model calls), and LatentDiffusion at 512^2 (4 PLMS steps, 5 model
    calls) with CLIP guidance through the VAE decoder. Seconds and attention launches of each; the
    latent path's 5 guidance decodes are the launches under autograd. Then every case the kernel met in
    these runs is held against its plain version (forward), and each case under autograd (dq, dk, dv)."""
    import torch

    from maua_tpu_torch.diffusion.image import get_diffusion_model, image_sample
    from maua_tpu_torch.diffusion.processors.latent import LatentDiffusion
    from maua_tpu_torch.grad import CLIPGrads

    tf32 = _default_tf32()
    prompt = os.path.join(tmp, "prompt.png")
    write_style_image(prompt, 224, seed=4)
    out = {}
    with autograd_attention_cases() as grad_cases, attention_cases_recorded() as cases:
        model = get_diffusion_model("stable", timesteps=5, sampler="lms", image=prompt, device="cuda", seed=0)
        img, s, n = timed_path(lambda: image_sample(image=prompt, sizes=((512, 512),), diffusion=model, seed=0,
                                                    verbose=False))
        check_image(img, (1, 512, 512, 3), "image-conditioned SD")
        out["image_cond_512"] = {"steps": 5, "seconds": s, "launches": n, "want": 51}
        del model
        for sampler, steps, calls in (("ddim", 5, 5), ("plms", 3, 4)):
            model = get_diffusion_model("guided", timesteps=steps, sampler=sampler, clip_scale=1000.0,
                                        guidance_speed="fast", device="cuda", seed=0)
            img, s, n = timed_path(lambda: image_sample(text=SD_PROMPT, sizes=((256, 256),), diffusion=model,
                                                        seed=0, verbose=False))
            check_image(img, (1, 256, 256, 3), f"guided diffusion {sampler}")
            out[f"guided_256_{sampler}"] = {"steps": steps, "model_calls": calls, "seconds": s, "launches": n,
                                            "want": 10 * calls}
            del model
            torch.cuda.empty_cache()
        ld = LatentDiffusion(grad_modules=[CLIPGrads(scale=1000.0, n_cutouts=SD_GUIDED_CUTOUTS, device="cuda")],
                             sampler="plms", timesteps=4, image_size=512, device="cuda", seed=0)
        img, s, n = timed_path(lambda: image_sample(text=SD_PROMPT, sizes=((512, 512),), diffusion=ld, seed=0,
                                                    verbose=False))
        check_image(img, (1, 512, 512, 3), "latent diffusion")
        out["latent_512_plms_clip"] = {"steps": 4, "model_calls": 5, "seconds": s, "launches": n, "want": 11 * 5 + 1}
        del ld, img
    torch.cuda.empty_cache()
    for name, r in out.items():
        if r["launches"] != r.pop("want"):
            raise AssertionError(f"sd_paths {name}: flash attention launched {r['launches']} times")
    launches = sum(r["launches"] for r in out.values())
    if sum(cases.values()) != launches or sum(grad_cases.values()) != 5:
        raise AssertionError(f"sd_paths: {sum(cases.values())} kernel calls recorded for {launches} launches, "
                             f"{sum(grad_cases.values())} under autograd, want 5 (the latent path's guidance decodes)")
    gradient_cases = check_attention_gradients(grad_cases, "sd_paths")
    forward_cases = check_attention_cases(cases, "sd_paths")
    return {**out, "launches_under_autograd": sum(grad_cases.values()), "gradient_cases": gradient_cases,
            "grad_max_rel_err": max(max(r["grad_rel_err"].values()) for r in gradient_cases),
            "attention_cases": forward_cases,
            "attention_max_abs_err": max(r["max_abs_err"] for r in forward_cases), **tf32}


SLICE_STEPS = 5  # steps of every sd_glide and sd_animation run (cut from the processors' 50 to 10, then 5)
VIDEO_STEPS = 10  # LMS timesteps of the sd_video runs (cut from the loop CLI's 100, the video CLI's 25, to 20, then 10)
VIDEO_FRAMES = 4  # frames of the flow-warped clips (cut from 8 for time)
TANGENT_BAR = 1e-4  # the forward-mode tangent against torch.func.jvp of the plain version: of its largest magnitude
BERT_TOL = 1e-4  # BERT card vs CPU, of the output's largest magnitude
# Horn-Schunck card vs CPU, in pixels: 160 clipped fixed-point iterations over 4 levels, each a 3x3 smoothing,
# two Sobel filters and a bilinear warp in f32 (TF32 off); the two devices' convolutions sum in other orders
# and their roundoff, ~1e-7 of a pixel an iteration, carries through the iterations that do not clip
HS_TOL = 1e-2
# the warp-and-blend of one frame card vs CPU, absolute on [-1, 1] images: the bilinear weights come from
# f32 coordinates that fused multiply-adds may round apart by ~1e-7 pixel, times the image's slope
WARP_TOL = 1e-4


@contextlib.contextmanager
def forward_mode_attention_cases():
    """Counts the kernel route's calls under a forward-mode transform (FlashAttention's jvp rule), by
    case: the dtype, the scale, and the size, strides and storage offset of q, k and v as the rule
    gets them."""
    import collections

    from maua_tpu_torch.kernels import attention as A

    cases = collections.Counter()
    real = A.FlashAttention.jvp

    def recording(ctx, *tangents):
        q, k, v = ctx.saved_tensors
        cases[(str(q.dtype).removeprefix("torch."), ctx.scale,
               *((tuple(t.shape), t.stride(), t.storage_offset()) for t in (q, k, v)))] += 1
        return real(ctx, *tangents)

    A.FlashAttention.jvp = staticmethod(recording)
    try:
        yield cases
    finally:
        A.FlashAttention.jvp = real


def check_forward_mode_cases(cases, what: str):
    """At every case the kernel route met under a forward-mode transform: random card tensors laid out
    as that case's q, k and v, and random tangents alike; torch.func.jvp through `FlashAttention` (the
    kernel forward, the recomputed f32 tangent) against torch.func.jvp of the plain version, TF32 off:
    the output with `attention_tolerance`, the tangent within TANGENT_BAR of its largest magnitude. The
    comparison launches do not count."""
    import torch

    from maua_tpu_torch.kernels import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    with tf32_off():
        for (dtype, scale, *layouts), n in sorted(cases.items(), key=lambda c: -c[1]):
            dt = getattr(torch, dtype)

            def laid_out():
                return tuple(torch.randn(off + sum((m - 1) * st for m, st in zip(size, stride)) + 1, generator=gen,
                                         device="cuda").to(dt).as_strided(size, stride, off)
                             for size, stride, off in layouts)

            primals, tangents = laid_out(), laid_out()
            out, tangent = torch.func.jvp(lambda q, k, v: A.FlashAttention.apply(q, k, v, scale), primals, tangents)
            ref, ref_tangent = torch.func.jvp(lambda q, k, v: A.flash_attention_plain(q, k, v, scale), primals,
                                              tangents)
            err = float((out.float() - ref.float()).abs().max())
            rel = float((tangent.float() - ref_tangent.float()).abs().max() / ref_tangent.float().abs().max())
            row = {"q": list(primals[0].shape), "kv": list(primals[1].shape),
                   "strides": [list(t.stride()) for t in primals], "dtype": dtype, "launches": n,
                   "max_abs_err": err, "tangent_rel_err": rel}
            if not bool(((out.float() - ref.float()).abs() <= attention_tolerance(ref, dt)).all()) or \
                    not rel <= TANGENT_BAR:
                raise AssertionError(f"{what}: the forward-mode route disagrees with the plain version at {row}")
            rows.append(row)
    A.reset_launches()
    return rows


@contextlib.contextmanager
def swapped(obj, name: str, value):
    """obj.name set to value within the block, then restored."""
    real = obj.__dict__[name] if isinstance(obj, type) else getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def counted_calls(obj, *names):
    """Counts calls of obj's methods or callable attributes `names` within the block."""
    import collections

    counts, saved = collections.Counter(), {}
    for name in names:
        saved[name] = obj.__dict__.get(name)
        real = getattr(obj, name)

        def counting(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        setattr(obj, name, counting)
    try:
        yield counts
    finally:
        for name, own in saved.items():
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)


def unet_card_vs_cpu(params, cfg, x, t, ctx):
    """One UNet evaluation on the card and on the CPU (the same parameters, copied), f32 with TF32 off:
    PSNR (peak: the CPU output's range), the largest difference, seconds of each and the card's attention
    launches."""
    import torch

    from maua_tpu_torch.diffusion.models import unet as U
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.utility import to_device

    with tf32_off(), torch.no_grad():
        A.reset_launches()
        t0 = time.perf_counter()
        card = U.forward(params, x.cuda(), t.cuda(), cfg, ctx.cuda()).cpu().numpy()
        card_s, launches = time.perf_counter() - t0, A.launches
        host_params = to_device(params, "cpu")
        t0 = time.perf_counter()
        host = U.forward(host_params, x.cpu(), t.cpu(), cfg, ctx.cpu()).numpy()
        host_s = time.perf_counter() - t0
    return {"psnr_db": psnr_db(card, host, float(host.max() - host.min())),
            "max_abs_diff": float(abs(card - host).max()), "card_seconds": card_s, "cpu_seconds": host_s,
            "launches": launches}


def run_sd_glide(tmp: str):
    """GLIDE at its published sizes (GLIDE_BASE at 64^2 with cfg 3, bicubic to 256^2, GLIDE_UPSAMPLE; DDIM
    cut from 50 to SLICE_STEPS steps a stage) and GLID3XL as get_diffusion_model builds it (SD 1.x UNet and
    VAE, a 768-wide 2-layer BERT, 256^2, PLMS SLICE_STEPS steps), each through image_sample from seed-0
    weights in f32: stage seconds and the attention launches of each, reset before and read after (GLIDE:
    14 a base evaluation, 10 an upsampler one; GLID3XL: 5 a UNet evaluation and the decode), every case
    held against the plain version. BERTEmbedder(BERTConfig()) alone (1280 wide, 32 layers, 77 tokens):
    seconds, and card vs CPU within BERT_TOL of its largest output. One evaluation of each GLIDE UNet card
    vs CPU, f32 with TF32 off: PSNR >= 40 dB."""
    import numpy as np
    import torch

    from maua_tpu_torch.diffusion.image import get_diffusion_model, image_sample
    from maua_tpu_torch.diffusion.processors.glide import GLIDE_BASE, GLIDE_UPSAMPLE
    from maua_tpu_torch.prompt import TextPrompt
    from maua_tpu_torch.text.bert import BERTConfig, BERTEmbedder
    from maua_tpu_torch.utility import to_device

    tf32 = _default_tf32()
    out = {}
    with attention_cases_recorded() as cases:
        t0 = time.perf_counter()
        glide = get_diffusion_model("glide", timesteps=SLICE_STEPS, cfg_scale=3.0, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s, stages = time.perf_counter() - t0, {}
        img, s, n = timed_path(lambda: image_sample(text=SD_PROMPT, sizes=((256, 256),), diffusion=glide, seed=0,
                                                    verbose=False, stage_times=stages))
        check_image(img, (1, 256, 256, 3), "GLIDE")
        out["glide"] = {"steps": SLICE_STEPS, "seconds": s, "init_seconds": init_s, "stage_seconds": stages,
                        "launches": n, "want": (14 + 10) * SLICE_STEPS}
        t0 = time.perf_counter()
        g3 = get_diffusion_model("glid3xl", timesteps=SLICE_STEPS, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        img, s, n = timed_path(lambda: image_sample(text=SD_PROMPT, sizes=((256, 256),), diffusion=g3, seed=0,
                                                    verbose=False))
        check_image(img, (1, 256, 256, 3), "GLID3XL")
        _, bert_s, _ = timed_path(lambda: g3.bert([SD_PROMPT]))
        out["glid3xl"] = {"steps": SLICE_STEPS, "model_calls": SLICE_STEPS + 1, "seconds": s, "init_seconds": init_s,
                          "bert_seconds": bert_s, "launches": n, "want": 5 * (SLICE_STEPS + 1) + 1}
        del g3, img
    torch.cuda.empty_cache()
    cond, uncond = glide.conditioning([TextPrompt(SD_PROMPT)])
    gen = torch.Generator().manual_seed(8)
    out["glide_unets_card_vs_cpu"] = {
        "base": unet_card_vs_cpu(glide.base_params, GLIDE_BASE, torch.randn(2, 3, 64, 64, generator=gen),
                                 torch.full((2,), 500.0), torch.cat([uncond, cond])),
        "upsample": unet_card_vs_cpu(glide.up_params, GLIDE_UPSAMPLE, torch.randn(1, 6, 256, 256, generator=gen),
                                     torch.full((1,), 500.0), cond)}
    del glide
    torch.cuda.empty_cache()
    for name in ("glide", "glid3xl"):
        if out[name]["launches"] != out[name].pop("want"):
            raise AssertionError(f"sd_glide {name}: flash attention launched {out[name]['launches']} times")
    unets = out["glide_unets_card_vs_cpu"]
    if unets["base"]["launches"] != 14 or unets["upsample"]["launches"] != 10 or \
            not all(u["psnr_db"] >= 40.0 for u in unets.values()):
        raise AssertionError(f"sd_glide: GLIDE UNets card vs CPU {unets}")
    if sum(cases.values()) != out["glide"]["launches"] + out["glid3xl"]["launches"]:
        raise AssertionError(f"sd_glide: {sum(cases.values())} kernel calls recorded")
    attention = check_attention_cases(cases, "sd_glide")

    bert = BERTEmbedder(BERTConfig(), device="cuda", seed=0)
    bert([SD_PROMPT])  # warm
    with tf32_off():
        card, bert_s, _ = timed_path(lambda: bert([SD_PROMPT]))
        host = BERTEmbedder(BERTConfig(), params=to_device(bert.params, "cpu"), device="cpu")
        t0 = time.perf_counter()
        want = host([SD_PROMPT]).numpy()
        host_s = time.perf_counter() - t0
    card = card.cpu().numpy()
    diff = float(np.abs(card - want).max())
    if card.shape != (1, 77, 1280) or not diff <= BERT_TOL * float(np.abs(want).max()):
        raise AssertionError(f"sd_glide: BERT card vs CPU {card.shape}, max abs diff {diff}")
    del bert, host
    return {**out, "bert_1280x32": {"tokens": 77, "seconds": bert_s, "cpu_seconds": host_s, "max_abs_diff": diff,
                                    "abs_max": float(np.abs(want).max())},
            "launches": out["glide"]["launches"] + out["glid3xl"]["launches"], "attention_cases": attention,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention), **tf32}


def write_frame(path: str, size: int, seed: int) -> np.ndarray:
    """A smooth colour field with seeded texture, (size, size, 3) in [0, 1], written as a PNG."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([0.5 + 0.4 * np.sin(6 * x + seed), y, 1 - x * y], -1) * 0.75 + rs.rand(size, size, 3) * 0.25
    Image.fromarray((img * 255).astype(np.uint8)).save(path)
    return img.astype(np.float32)


def run_sd_animation(tmp: str):
    """The diffusion animations at 512^2 through SD 1.x (seed-0 weights, f32, SLICE_STEPS LMS timesteps):
    interpolate_latents between 2 synthetic images, 8 frames, renoised from t 0.5; klmc2_animation, 8
    frames with forward-mode Hessian-vector products (the CLI's sigma, step, friction, alpha and cfg 5);
    outpaint from 512^2 onto 640^2 from t 0.4; loop_video, 8 frames in batches of 4. Seconds and the
    attention launches of each, reset before and read after (10 a UNet evaluation, 1 an encode or a
    decode), every case held against the plain version, and every case the kernel route met under
    forward mode held (output and tangent) against torch.func.jvp of the plain version. One KLMC2 score
    evaluation with its jvp, and one without, under torch.profiler (profile_batch); the KLMC2 chain
    again, warm (its seconds only)."""
    import torch

    from maua_tpu_torch.diffusion.image import get_diffusion_model
    from maua_tpu_torch.diffusion.interpolate import interpolate_latents
    from maua_tpu_torch.diffusion.klmc2 import klmc2_animation, score_from_denoiser
    from maua_tpu_torch.diffusion.loop import loop_video
    from maua_tpu_torch.diffusion.outpaint import outpaint
    from maua_tpu_torch.diffusion.wrappers import cfg_denoiser
    from maua_tpu_torch.prompt import TextPrompt

    tf32 = _default_tf32()
    model = get_diffusion_model("stable", timesteps=SLICE_STEPS, sampler="lms", device="cuda", seed=0)
    images = [os.path.join(tmp, f"key{i}.png") for i in range(2)]
    init = torch.from_numpy(write_frame(images[0], 512, 0) * 2 - 1)[None].cuda()
    write_frame(images[1], 512, 1)
    n_steps = {t: len(model.get_sigmas(t, 1.0)) - 1 for t in (0.4, 0.5, 0.6)}
    out = {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    def frames_ok(frames, n, what):
        frames = torch.as_tensor(frames)
        check_image(frames, (n, 512, 512, 3), what)
        if float((frames[0] - frames[-1]).abs().max()) < 1e-3:
            raise AssertionError(f"{what}: the first and last frames are the same")

    torch.cuda.reset_peak_memory_stats()
    with attention_cases_recorded() as cases, forward_mode_attention_cases() as fwd_cases:
        frames, s, n = timed_path(lambda: interpolate_latents(model, images, n_frames=8, renoise_t=0.5, gen=gen()))
        frames_ok(frames, 8, "interpolate")
        out["interpolate"] = {"frames": 8, "seconds": s, "launches": n, "want": 2 + 10 * n_steps[0.5] + 1}
        frames, s, n = timed_path(lambda: klmc2_animation(
            model, shape=(512, 512), n_frames=8, sigma=0.75, step_size=0.2, text=SD_PROMPT, cond_scale=5.0,
            friction=0.5, alpha=1e-3, tau=1.0, use_hvp=True, gen=gen()))
        frames_ok(frames, 8, "klmc2")
        out["klmc2"] = {"frames": 8, "seconds": s, "launches": n, "launches_in_jvp": sum(fwd_cases.values()),
                        "want": 10 * 8 + 1}
        img, s, n = timed_path(lambda: outpaint(model, init, expand=(64, 64, 64, 64), text=SD_PROMPT, t_start=0.4,
                                                gen=gen()))
        check_image(img, (1, 640, 640, 3), "outpaint")
        if not bool((img[:, 64:576, 64:576] == init).all()):
            raise AssertionError("outpaint: the interior is not kept")
        out["outpaint"] = {"canvas": [640, 640], "seconds": s, "launches": n, "want": 5 * n_steps[0.4] + 2}
        frames, s, n = timed_path(lambda: loop_video(model, init, n_frames=8, batch_size=4, text=SD_PROMPT,
                                                     verbose=False))
        frames_ok(frames, 8, "loop")
        out["loop"] = {"frames": 8, "seconds": s, "launches": n, "want": 1 + 2 * (10 * n_steps[0.6] + 1)}
        del frames, img
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, out["klmc2"]["warm_seconds"], _ = timed_path(lambda: klmc2_animation(  # the same chain again, warm
        model, shape=(512, 512), n_frames=8, sigma=0.75, step_size=0.2, text=SD_PROMPT, cond_scale=5.0,
        friction=0.5, alpha=1e-3, tau=1.0, use_hvp=True, gen=gen()))
    # one KLMC2 score evaluation with its Hessian-vector product (torch.func.jvp), and the score alone
    cond, uncond = model.conditioning([TextPrompt(SD_PROMPT)])
    score = score_from_denoiser(cfg_denoiser(model.denoiser, cond, uncond, 5.0), 0.75)
    x, v = (torch.randn(1, 4, 64, 64, generator=gen(), device="cuda") * 0.75 for _ in range(2))
    with torch.no_grad():
        profiles = {"score_jvp": profile_batch(lambda: torch.func.jvp(score, (x,), (v,)), "flash_attention"),
                    "score": profile_batch(lambda: score(x), "flash_attention")}
    del model
    torch.cuda.empty_cache()
    for name, r in out.items():
        if r["launches"] != r.pop("want"):
            raise AssertionError(f"sd_animation {name}: flash attention launched {r['launches']} times")
    launches = sum(r["launches"] for r in out.values())
    if sum(cases.values()) != launches or sum(fwd_cases.values()) != 10 * 8:
        raise AssertionError(f"sd_animation: {sum(cases.values())} kernel calls recorded for {launches} launches, "
                             f"{sum(fwd_cases.values())} under forward mode, want 80 (KLMC2's jvps)")
    shapes = {tuple(layouts[0][0]) for _, _, *layouts in cases}
    if not {(2, 8, 6400, 40), (1, 1, 6400, 512)} <= shapes:
        raise AssertionError(f"sd_animation: outpainting's 640^2 cases are missing from {sorted(shapes)}")
    forward_mode = check_forward_mode_cases(fwd_cases, "sd_animation")
    attention = check_attention_cases(cases, "sd_animation")
    return {**out, "launches": launches, "peak_mem_gib": peak, "profiles": profiles, "forward_mode_cases": forward_mode,
            "tangent_max_rel_err": max(r["tangent_rel_err"] for r in forward_mode), "attention_cases": attention,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention), **tf32}


def write_flow_clip(path: str, n: int = VIDEO_FRAMES, size: int = 512, shift=(3, 1)):
    """A textured 512^2 image shifted (dx, dy) pixels a frame (wrapping), n frames written by the port's
    write_video; returns the frames (n, size, size, 3) in [0, 1]."""
    import numpy as np

    from maua_tpu_torch.ops.video import write_video

    rs = np.random.RandomState(9)
    y, x = np.mgrid[0:size, 0:size] / size
    base = np.stack([0.5 + 0.3 * np.sin(12 * x) * np.cos(9 * y), y, 0.5 + 0.4 * np.sin(7 * (x + y))], -1)
    base = (0.8 * base + 0.2 * rs.rand(size // 8, size // 8, 3).repeat(8, 0).repeat(8, 1)).astype(np.float32)
    frames = np.stack([np.roll(base, (shift[1] * i, shift[0] * i), axis=(0, 1)) for i in range(n)])
    write_video(frames, path, fps=8, value_range=(0, 1))
    return frames


FLOW_NETS = ("spynet", "pwc", "liteflownet", "unflow", "raft", "gma")
# each estimator's first checkpoint name in the registry (maua_tpu_torch/flow/models.py)
FLOW_CHECKPOINTS = {"spynet": "spynet.pth", "pwc": "pwc.pth", "liteflownet": "liteflownet.pth",
                    "unflow": "unflow.pth", "raft": "raft_large.pth", "gma": "gma-sintel.pth"}


def _flow_tree_to_published(name: str, tree) -> dict:
    """The port's flow parameter tree -> the published checkpoint's keys (the inverse of each
    estimator's `params_from_torch`): sniklaus spynet / pwc / liteflownet, pytorch-unflow CSS,
    torchvision raft_large (context-encoder norms as batch norms, feature-encoder instance norms
    without weights) and zacjiang GMA (a `module.` prefix, attention convs without biases)."""
    sd = {}

    def put(key, p, bias=True):
        sd[f"{key}.weight"] = p["w"]
        if bias:
            sd[f"{key}.bias"] = p["b"]

    def seq(prefix, convs):
        for i, p in enumerate(convs):
            put(f"{prefix}.{2 * i}", p)

    def norm(key, p, batch):
        if batch:
            sd.update({f"{key}.weight": p["g"], f"{key}.bias": p["b"], f"{key}.running_mean": p["b"] * 0,
                       f"{key}.running_var": p["g"] * 1})

    def encoder(base, enc, batch, names):
        conv1, norm1, conv2, bconv, bnorm = names
        put(f"{base}.{conv1}", enc["conv1"])
        norm(f"{base}.{norm1}", enc["norm1"], batch)
        put(f"{base}.{conv2}", enc["conv2"])
        for layer in ("layer1", "layer2", "layer3"):
            for bi, blk in enumerate(enc[layer]):
                bb = f"{base}.{layer}.{bi}"
                for j in ("1", "2"):
                    put(f"{bb}.{bconv.format(j)}", blk[f"conv{j}"])
                    norm(f"{bb}.{bnorm.format(j)}", blk[f"norm{j}"], batch)
                if "down" in blk:
                    put(f"{bb}.downsample.0", blk["down"])
                    norm(f"{bb}.downsample.1", blk["dnorm"], batch)

    if name == "spynet":
        for lvl, unit in enumerate(tree):
            seq(f"netBasic.{lvl}.netBasic", unit["convs"])
    elif name == "pwc":
        names = ["netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"]
        for nm, level in zip(names, tree["extractor"]):
            seq(f"netExtractor.{nm}", level)
        for lvl, nm in ((6, "netSix"), (5, "netFiv"), (4, "netFou"), (3, "netThr"), (2, "netTwo")):
            dec = tree["decoders"][lvl]
            for sub, p in zip(names, dec["convs"]):
                put(f"{nm}.{sub}.0", p)
            if lvl != 6:
                put(f"{nm}.netUpflow", dec["upflow"])
                put(f"{nm}.netUpfeat", dec["upfeat"])
        seq("netRefiner.netMain", tree["refiner"])
    elif name == "liteflownet":
        from maua_tpu_torch.flow.liteflownet import LEVELS

        for part, convs in tree["features"].items():
            seq(f"netFeatures.net{part.capitalize()}", convs)
        for i, lvl in enumerate(LEVELS):
            m, s, r = tree[f"matching{lvl}"], tree[f"subpixel{lvl}"], tree[f"regularization{lvl}"]
            seq(f"netMatching.{i}.netFeat", m["feat"])
            seq(f"netMatching.{i}.netMain", m["main"])
            for key, mod in (("upflow", "netUpflow"), ("upcorr", "netUpcorr")):
                if key in m:
                    sd[f"netMatching.{i}.{mod}.weight"] = m[key]
            seq(f"netSubpixel.{i}.netFeat", s["feat"])
            seq(f"netSubpixel.{i}.netMain", s["main"])
            for key, mod in (("feat", "netFeat"), ("main", "netMain"), ("dist", "netDist"), ("scale_x", "netScaleX"),
                             ("scale_y", "netScaleY")):
                seq(f"netRegularization.{i}.{mod}", r[key])
    elif name == "unflow":
        from maua_tpu_torch.flow.unflow import _stage_specs

        for s, p in enumerate(tree):
            pre = f"netFlownets.{s}"
            for part, *_ in _stage_specs(s == 0):
                put(f"{pre}.net{part.title().replace('_', '')}.0", p[part])
            put(f"{pre}.netUpconv.netSixOut.0", p["flow_six"])
            for part in ("fiv", "fou", "thr", "two"):
                put(f"{pre}.netUpconv.net{part.title()}Next.0", p[f"up_{part}"])
                put(f"{pre}.netUpconv.net{part.title()}Up.0", p[f"upflow_{part}"])
                put(f"{pre}.netUpconv.net{part.title()}Out.0", p[f"flow_{part}"])
    elif name == "raft":
        names = ("convnormrelu.0", "convnormrelu.1", "conv", "convnormrelu{}.0", "convnormrelu{}.1")
        encoder("feature_encoder", tree["fnet"], False, names)
        encoder("context_encoder", tree["cnet"], True, names)
        for key, mod in (("convc1", "convcorr1"), ("convc2", "convcorr2"), ("convf1", "convflow1"),
                         ("convf2", "convflow2"), ("conv", "conv")):
            put(f"update_block.motion_encoder.{mod}.0", tree["motion"][key])
        for g, tv in (("z", "convz"), ("r", "convr"), ("q", "convq")):
            for j in ("1", "2"):
                put(f"update_block.recurrent_block.convgru{j}.{tv}", tree["gru"][f"{g}{j}"])
        put("update_block.flow_head.conv1", tree["flow_head"]["conv1"])
        put("update_block.flow_head.conv2", tree["flow_head"]["conv2"])
        put("mask_predictor.convrelu.0", tree["mask"]["conv1"])
        put("mask_predictor.conv", tree["mask"]["conv2"])
    elif name == "gma":
        names = ("conv1", "norm1", "conv2", "conv{}", "norm{}")
        encoder("module.fnet", tree["fnet"], False, names)
        encoder("module.cnet", tree["cnet"], True, names)
        ub = "module.update_block"
        for key in ("convc1", "convc2", "convf1", "convf2", "conv"):
            put(f"{ub}.encoder.{key}", tree["motion"][key])
        for g in ("z", "r", "q"):
            for j in ("1", "2"):
                put(f"{ub}.gru.conv{g}{j}", tree["gru"][f"{g}{j}"])
        put(f"{ub}.flow_head.conv1", tree["flow_head"]["conv1"])
        put(f"{ub}.flow_head.conv2", tree["flow_head"]["conv2"])
        put(f"{ub}.mask.0", tree["mask"]["conv1"])
        put(f"{ub}.mask.2", tree["mask"]["conv2"])
        put("module.att.to_qk", tree["gma"]["to_qk"], bias=False)
        put(f"{ub}.aggregator.to_v", tree["gma"]["to_v"], bias=False)
        sd[f"{ub}.aggregator.gamma"] = tree["gma"]["gamma"].reshape(1)
    else:
        raise ValueError(f"unknown flow estimator {name!r}")
    return sd


def flow_checkpoint(name: str, seed: int = 0) -> dict:
    """A synthetic checkpoint of a neural flow estimator in its published key layout, numpy f32:
    the shapes of the port's init_params, every weight redrawn from `seed` at the init's scale,
    biases 0.01 N(0, 1), batch norms with weights 1 + 0.1 N, biases and running means 0.1 N and
    running variances U(0.5, 1.5), GMA's gamma 0.5."""
    import numpy as np
    import torch

    import maua_tpu_torch.flow.liteflownet as LFN
    import maua_tpu_torch.flow.pwc as PWC
    import maua_tpu_torch.flow.raft as RAFT
    import maua_tpu_torch.flow.spynet as SPY
    import maua_tpu_torch.flow.unflow as UNF

    init = {"spynet": SPY.init_params, "pwc": PWC.init_params, "liteflownet": LFN.init_params,
            "unflow": UNF.init_params, "raft": RAFT.init_params,
            "gma": lambda g: RAFT.init_params(g, gma=True)}[name]
    sd = _flow_tree_to_published(name, init(torch.Generator().manual_seed(seed)))
    rs = np.random.RandomState(seed)
    out = {}
    for key, v in sd.items():
        v = v.numpy()
        stem = key.rsplit(".", 1)[0]
        batch_norm = f"{stem}.running_mean" in sd
        if key.endswith("running_var"):
            a = rs.uniform(0.5, 1.5, v.shape)
        elif key.endswith("running_mean") or (batch_norm and key.endswith("bias")):
            a = 0.1 * rs.randn(*v.shape)
        elif batch_norm:  # a batch norm's weight
            a = 1.0 + 0.1 * rs.randn(*v.shape)
        elif key.endswith("gamma"):
            a = np.full(v.shape, 0.5)
        elif key.endswith("bias"):
            a = 0.01 * rs.randn(*v.shape)
        else:
            a = rs.randn(*v.shape) * float(v.std())
        out[key] = a.astype(np.float32)
    return out


def run_sd_video(tmp: str):
    """The flow-warped video over a synthetic 8-frame 512^2 clip (a texture shifted 3 px right and 1 down a
    frame), SD 1.x from seed-0 weights in f32: video_sample at its defaults (Farneback, skip 0.7, first_skip
    0.4, blend 2, consistency trust 0.75, noise injection 0.02) over VIDEO_STEPS LMS timesteps, the video
    written and read back; then loop_direct_sample over the same clip with blend_every 0.1 (6 passes of 2
    steps from skip 0.4). Flow seconds (host), seconds per frame, the attention launches (reset before and
    read after: 10 a UNet evaluation, 1 an encode or a decode), every case held against the plain version.
    Card vs CPU, TF32 off: Horn-Schunck flow between the first two frames within HS_TOL pixels, and the
    warp-and-blend of one frame within WARP_TOL."""
    import numpy as np
    import torch

    from maua_tpu_torch import utility
    from maua_tpu_torch.diffusion.image import get_diffusion_model
    from maua_tpu_torch.diffusion.loop_direct import _blend_init, loop_direct_sample
    from maua_tpu_torch.diffusion.video import video_sample
    from maua_tpu_torch.flow.lib import preprocess_optical_flow
    from maua_tpu_torch.flow.models import farneback_flow, hs_flow
    from maua_tpu_torch.ops.video import read_video

    tf32 = _default_tf32()
    workspace, utility.WORKSPACE = utility.WORKSPACE, os.path.join(tmp, "workspace")
    try:
        clip = os.path.join(tmp, "flow_clip.mp4")
        write_flow_clip(clip)
        model = get_diffusion_model("stable", timesteps=VIDEO_STEPS, sampler="lms", device="cuda", seed=0)
        out_file, out, stages = os.path.join(tmp, "flow_diffused.mp4"), {}, {}
        with attention_cases_recorded() as cases, \
                counted_calls(model, "encode", "decode") as coded, counted_calls(model.denoiser, "eps_model") as evals:
            written, s, n = timed_path(lambda: video_sample(model, clip, out_file=out_file, text=SD_PROMPT,
                                                            size=(512, 512), stage_times=stages, verbose=False))
            back, _ = read_video(written)
            want = 10 * evals["eps_model"] + coded["encode"] + coded["decode"]
            out["video"] = {"frames_written": VIDEO_FRAMES, "frames_read_back": int(back.shape[0]), "seconds": s,
                            "flow_seconds": stages["flow"], "seconds_per_frame": (s - stages["flow"]) / VIDEO_FRAMES,
                            "unet_evaluations": evals["eps_model"], "launches": n, "want": want}
            if back.shape != (VIDEO_FRAMES, 512, 512, 3) or back.min() == back.max():
                raise AssertionError(f"sd_video: read back {back.shape}, want {VIDEO_FRAMES} non-constant 512^2 frames")
            evals.clear(), coded.clear()
            ld_stages = {}
            frames, s, n = timed_path(lambda: loop_direct_sample(model, clip, text=SD_PROMPT, size=(512, 512),
                                                                 timesteps=VIDEO_STEPS, blend_every=0.1,
                                                                 stage_times=ld_stages, verbose=False))
            check_image(torch.from_numpy(frames), (VIDEO_FRAMES, 512, 512, 3), "loop_direct")
            calls = coded["decode"]
            out["loop_direct"] = {"passes": calls // VIDEO_FRAMES, "diffusion_calls": calls, "seconds": s,
                                  "flow_seconds": ld_stages["flow"], "unet_evaluations": evals["eps_model"],
                                  "launches": n, "want": 10 * evals["eps_model"] + coded["encode"] + calls}
            if calls < 2 * VIDEO_FRAMES:
                raise AssertionError(f"sd_video: loop_direct made {calls} diffusion calls, want two passes or more")
        del model
        torch.cuda.empty_cache()
        for name, r in out.items():
            if r["launches"] != r.pop("want") or r["launches"] == 0:
                raise AssertionError(f"sd_video {name}: flash attention launched {r['launches']} times")
        if sum(cases.values()) != out["video"]["launches"] + out["loop_direct"]["launches"]:
            raise AssertionError(f"sd_video: {sum(cases.values())} kernel calls recorded")
        attention = check_attention_cases(cases, "sd_video")

        frames, forward, _, reliable = preprocess_optical_flow(clip, farneback_flow)
        with tf32_off():
            flows, seconds = {}, {}
            for dev in ("cuda", "cpu"):
                hs_flow(frames[0], frames[1], device=dev)  # warm
                t0 = time.perf_counter()
                flows[dev] = hs_flow(frames[0], frames[1], device=dev).cpu().numpy()
                seconds[dev] = time.perf_counter() - t0
            blends = {dev: _blend_init(torch.as_tensor(frames[1][None] * 2 - 1, device=dev),
                                       torch.as_tensor(frames[0][None] * 2 - 1, device=dev),
                                       torch.as_tensor(np.asarray(forward[0]), device=dev),
                                       torch.as_tensor(np.asarray(reliable[0]), device=dev), 0.75, 2.0).cpu().numpy()
                      for dev in ("cuda", "cpu")}
        hs_diff = float(np.abs(flows["cuda"] - flows["cpu"]).max())
        warp_diff = float(np.abs(blends["cuda"] - blends["cpu"]).max())
        if not (hs_diff <= HS_TOL and warp_diff <= WARP_TOL):
            raise AssertionError(f"sd_video card vs CPU: Horn-Schunck {hs_diff} px, warp and blend {warp_diff}")
        reference = {"hs_max_abs_diff_px": hs_diff, "hs_card_seconds": seconds["cuda"],
                     "hs_cpu_seconds": seconds["cpu"], "hs_mean_flow_px": flows["cpu"].mean((0, 1)).tolist(),
                     "farneback_mean_flow_px": np.asarray(forward[0]).mean((0, 1)).tolist(),
                     "warp_blend_max_abs_diff": warp_diff}
    finally:
        utility.WORKSPACE = workspace
    return {**out, "launches": out["video"]["launches"] + out["loop_direct"]["launches"],
            "attention_cases": attention, "attention_max_abs_err": max(r["max_abs_err"] for r in attention),
            "card_vs_cpu": reference, **tf32}


FLOW_TOL = 1e-2  # neural flows card vs CPU at 256^2, TF32 off: px
STYLE_LBFGS_ITERS = 10  # L-BFGS iterations of the style phase's rgb transfer (cut from the CLI's 512 to 20, then 10)
STYLE_VQGAN_ITERS = 5  # Adam iterations of its vqgan transfer (cut from 10 for time)
STYLE_PSNR_BAR = 40.0  # the style loss's gradient card vs CPU at 128^2, TF32 off: dB


def write_flow_checkpoints(zoo: str, names=FLOW_NETS) -> None:
    """Each estimator's synthetic published checkpoint under its first registry file name in `zoo`."""
    import torch

    os.makedirs(zoo, exist_ok=True)
    for name in names:
        torch.save({k: torch.from_numpy(v) for k, v in flow_checkpoint(name).items()},
                   os.path.join(zoo, FLOW_CHECKPOINTS[name]))


@contextlib.contextmanager
def flow_dirs(tmp: str, tag: str, names=FLOW_NETS):
    """utility.MODELZOO holding the estimators' synthetic checkpoints and a WORKSPACE of its own, within the block."""
    from maua_tpu_torch import utility

    zoo = os.path.join(tmp, f"modelzoo_{tag}")
    write_flow_checkpoints(zoo, names)
    saved = utility.MODELZOO, utility.WORKSPACE
    utility.MODELZOO, utility.WORKSPACE = zoo, os.path.join(tmp, f"workspace_{tag}")
    try:
        yield
    finally:
        utility.MODELZOO, utility.WORKSPACE = saved


def run_flow_neural(tmp: str):
    """The five neural estimators (spynet, pwc, liteflownet, unflow, raft and gma) from synthetic checkpoints
    in their published layouts, through get_flow_model on the card over write_flow_clip's 8-frame 512^2 pan
    (3 px right, 1 down a frame): seconds per pair (warm), the mean and largest flow. Card vs CPU, TF32 off,
    on one 256^2 pair per estimator within FLOW_TOL px. Then video_sample over the clip with flow_models
    ("raft",) (VIDEO_STEPS LMS timesteps, SD 1.x from seed 0, f32): seconds, the flow's seconds, frames read
    back, attention launches (reset before and read after; 10 a UNet evaluation, 1 an encode or decode),
    every case held against the plain version."""
    import numpy as np
    import torch

    from maua_tpu_torch.diffusion.image import get_diffusion_model
    from maua_tpu_torch.diffusion.video import video_sample
    from maua_tpu_torch.flow.models import get_flow_model
    from maua_tpu_torch.ops.video import read_video

    tf32 = _default_tf32()
    out = {}
    with flow_dirs(tmp, "flow"):
        clip = os.path.join(tmp, "neural_flow_clip.mp4")
        frames = write_flow_clip(clip)
        for name in FLOW_NETS:
            model = get_flow_model((name,), device="cuda")
            model(frames[0], frames[1])  # warm
            t0 = time.perf_counter()
            flows = np.stack([model(frames[i], frames[i + 1]) for i in range(len(frames) - 1)])
            s = (time.perf_counter() - t0) / (len(frames) - 1)
            if flows.shape != (len(frames) - 1, 512, 512, 2) or not np.isfinite(flows).all():
                raise AssertionError(f"flow_neural {name}: flows {flows.shape}, want finite (7, 512, 512, 2)")
            out[name] = {"seconds_per_pair": s, "mean_flow_px": flows.mean((0, 1, 2)).tolist(),
                         "max_abs_flow_px": float(np.abs(flows).max())}
            del model
            torch.cuda.empty_cache()
        small = frames[:2, ::2, ::2]
        with tf32_off():
            for name in FLOW_NETS:
                got = {dev: get_flow_model((name,), device=dev)(small[0], small[1]) for dev in ("cuda", "cpu")}
                diff = float(np.abs(got["cuda"] - got["cpu"]).max())
                out[name].update(card_vs_cpu_px=diff, card_vs_cpu_of_px=float(np.abs(got["cpu"]).max()))
                if not diff <= FLOW_TOL:
                    raise AssertionError(f"flow_neural {name}: card vs CPU {diff} px")
        model = get_diffusion_model("stable", timesteps=VIDEO_STEPS, sampler="lms", device="cuda", seed=0)
        out_file, stages = os.path.join(tmp, "raft_diffused.mp4"), {}
        with attention_cases_recorded() as cases, \
                counted_calls(model, "encode", "decode") as coded, counted_calls(model.denoiser, "eps_model") as evals:
            written, s, n = timed_path(lambda: video_sample(model, clip, out_file=out_file, text=SD_PROMPT,
                                                            size=(512, 512), flow_models=("raft",),
                                                            stage_times=stages, verbose=False))
            want = 10 * evals["eps_model"] + coded["encode"] + coded["decode"]
        back, _ = read_video(written)
        del model
        torch.cuda.empty_cache()
        if back.shape != (VIDEO_FRAMES, 512, 512, 3) or back.min() == back.max():
            raise AssertionError(f"flow_neural video: read back {back.shape}")
        if n != want or n == 0 or sum(cases.values()) != n:
            raise AssertionError(f"flow_neural video: {n} launches, {sum(cases.values())} recorded, want {want}")
        attention = check_attention_cases(cases, "flow_neural")
        out["video"] = {"seconds": s, "flow_seconds": stages["flow"], "frames_read_back": int(back.shape[0]),
                        "seconds_per_frame": (s - stages["flow"]) / VIDEO_FRAMES,
                        "unet_evaluations": evals["eps_model"], "launches": n}
    return {**out, "launches": n, "attention_cases": attention,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention), **tf32}


def style_loss_and_grad(content: str, style: str, size: int, device: str, vgg):
    """One evaluation of style/image.transfer's loss (rgb from the content, kbc-vgg19 with the given
    parameters, its default weights) and its gradient, at size^2 on `device`."""
    import torch

    from maua_tpu_torch.loss import gram_matrix, scaled_mse_loss, tv_loss
    from maua_tpu_torch.ops.image import resample
    from maua_tpu_torch.ops.io import load_images
    from maua_tpu_torch.parameterizations import load_parameterization
    from maua_tpu_torch.style.image import build_perceptor, style_targets, to_image

    c, (s,) = load_images(content, [style])
    c, s = resample(to_image(c, device), size), resample(to_image(s, device), size)
    percept = build_perceptor("kbc-vgg19", {"params": vgg}, device)
    pastiche = load_parameterization("rgb")(size, size, tensor=c, device=device)
    with torch.no_grad():
        feats = percept.get_features(c)
        content_targets = [feats[i] for i in percept.content_layers]
    targets = style_targets(percept, [s])
    img = pastiche.decode()
    feats = percept.get_features(img)
    loss = 100.0 * tv_loss(img)
    for i, t in zip(percept.content_layers, content_targets):
        loss = loss + scaled_mse_loss(feats[i], t)
    for i, t in zip(percept.style_layers, targets):
        loss = loss + 50.0 * scaled_mse_loss(gram_matrix(feats[i]), t)
    loss.backward()
    return float(loss.detach()), pastiche.tensor.grad.cpu().numpy()


def run_style(tmp: str):
    """style/image.transfer at 512^2 (the CLI's size): rgb + kbc-vgg19 + lbfgs (STYLE_LBFGS_ITERS iterations,
    cut from 512): seconds and loss evaluations per iteration (the zoom linesearch's), peak memory; then
    vqgan (its in-tree AutoencoderKL decoder from seed 0, init_type "random") + adam for STYLE_VQGAN_ITERS
    iterations (per-iteration seconds: the optimization loop's, set-up apart): the decoder's (1, 1, 16384, 128)
    mid attention runs through the kernel route's FlashAttention
    under autograd, one launch an iteration and one for the final decode; every case held against the
    plain version, forward and dq, dk, dv. Card vs CPU, TF32 off, at 128^2: one loss and gradient
    evaluation (rgb), the gradient's PSNR (peak: its largest magnitude) at least STYLE_PSNR_BAR."""
    import numpy as np
    import torch

    from maua_tpu_torch.perceptors import vgg as VGG
    from maua_tpu_torch.style.image import transfer

    tf32 = _default_tf32()
    content, style = os.path.join(tmp, "style_content.png"), os.path.join(tmp, "style_style.png")
    write_frame(content, 512, 5)
    write_style_image(style, 512, seed=4)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    img, s, n = timed_path(lambda: transfer(content, [style], n_iters=STYLE_LBFGS_ITERS, device="cuda",
                                            stats=stats, verbose=False))
    check_image(img, (1, 512, 512, 3), "style rgb")
    out["rgb_lbfgs"] = {"seconds": s, "seconds_per_iteration": stats["loop_seconds"] / STYLE_LBFGS_ITERS,
                        "evaluations_per_iteration": stats["evaluations"] / STYLE_LBFGS_ITERS, "launches": n,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.reset_peak_memory_stats()
    with attention_cases_recorded() as cases, autograd_attention_cases() as grad_cases:
        img, s, n = timed_path(lambda: transfer(content, [style], parameterization="vqgan", init_type="random",
                                                optimizer="adam", lr=0.05, n_iters=STYLE_VQGAN_ITERS, device="cuda",
                                                stats=stats, verbose=False))
    check_image(img, (1, 512, 512, 3), "style vqgan")
    if n != STYLE_VQGAN_ITERS + 1 or sum(cases.values()) != n or sum(grad_cases.values()) != STYLE_VQGAN_ITERS:
        raise AssertionError(f"style vqgan: {n} launches, {sum(cases.values())} recorded, "
                             f"{sum(grad_cases.values())} under autograd")
    out["vqgan_adam"] = {"seconds": s, "seconds_per_iteration": stats["loop_seconds"] / STYLE_VQGAN_ITERS,
                         "launches": n, "launches_under_autograd": sum(grad_cases.values()),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.empty_cache()
    attention = check_attention_cases(cases, "style")
    gradients = check_attention_gradients(grad_cases, "style")
    vgg = VGG.init_params(torch.Generator().manual_seed(0))
    with tf32_off():
        (loss_card, grad_card), (loss_cpu, grad_cpu) = (style_loss_and_grad(content, style, 128, dev, vgg)
                                                        for dev in ("cuda", "cpu"))
    psnr = psnr_db(grad_card, grad_cpu, float(np.abs(grad_cpu).max()))
    if not psnr >= STYLE_PSNR_BAR:
        raise AssertionError(f"style card vs CPU: gradient {psnr} dB")
    out["card_vs_cpu"] = {"loss_card": loss_card, "loss_cpu": loss_cpu, "grad_psnr_db": psnr}
    return {**out, "launches": n, "attention_cases": attention, "gradient_cases": gradients,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention), **tf32}


def run_style_video(tmp: str):
    """style/video.transfer at its defaults (256^2, 4 passes, 64 Adam iterations a frame, blending and the
    temporal loss on, kbc-vgg19 from seed 0) over write_flow_clip's 8-frame 512^2 pan, with flow_models
    ("raft",) from the synthetic raft_large checkpoint: the video written and read back, seconds per frame,
    the flow's seconds."""
    import numpy as np

    from maua_tpu_torch.ops.video import read_video, write_video
    from maua_tpu_torch.style.video import transfer

    tf32 = _default_tf32()
    with flow_dirs(tmp, "style_video", ("raft",)):
        clip, style = os.path.join(tmp, "style_clip.mp4"), os.path.join(tmp, "video_style.png")
        write_flow_clip(clip)
        write_style_image(style, 512, seed=5)
        stages = {}
        video, s, n = timed_path(lambda: transfer(clip, [style], flow_models=("raft",), device="cuda",
                                                  stage_times=stages, verbose=False))
        out_file = os.path.join(tmp, "style_video.mp4")
        write_video(video, out_file, fps=8)
        back, _ = read_video(out_file)
    if back.shape != (VIDEO_FRAMES, 256, 256, 3) or not np.isfinite(video).all() or back.min() == back.max():
        raise AssertionError(f"style_video: read back {back.shape}")
    return {"seconds": s, "flow_seconds": stages["flow"], "passes_seconds": stages["passes"],
            "seconds_per_frame": stages["passes"] / VIDEO_FRAMES, "frames_read_back": int(back.shape[0]),
            "launches": n, **tf32}


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


S2D_AB_PAIRS = 3  # s2d / plain pairs of the fast phase's A/B, in the order P N N P P N (cut from 6 for time)
S2D_AB_BATCHES = 5  # timed batches per turn, after two warm-ups; the median is the turn's time
S2D_AB_OTHER_PAIRS = 3  # pairs of the fast phase's f32, batch-1 and 512^2 A/Bs (cut from 5 for time)


@contextlib.contextmanager
def tf32_off():
    """f32 matmuls and cuDNN convolutions in full f32 within the block; the flags are restored after."""
    import torch

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def psnr_db(a, b, peak: float) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * math.log10(peak**2 / max(mse, 1e-20))


def snr_db(a, ref) -> float:
    """10 log10 of ref's mean square over the mean squared difference: the PSNR of an image that does not
    keep to its nominal range (a random-init net's output) read against its own signal."""
    import numpy as np

    ref = np.asarray(ref, np.float64)
    return 10 * math.log10(float(np.mean(ref**2)) / max(float(np.mean((np.asarray(a, np.float64) - ref) ** 2)), 1e-30))


def tail_macs(plan, cfg) -> dict:
    """Multiply-adds per frame of the s2d blocks, from the plan's kernel shapes
    (kh, kw, ci, co) over each block's (res / 2)^2 cells, beside the plain
    route's convs of the same blocks (conv0 as the transposed conv at the
    input grid, conv1 at res, torgb)."""
    s2d, plain = {}, {}
    for res, e in plan["blocks"].items():
        cells = (res // 2) ** 2
        s2d[f"b{res}"] = {k: cells * int(math.prod(e[k].shape)) for k in ("k0", "k1", "kt", "kimg") if k in e}
        ci, co = cfg.channels(res // 2), cfg.channels(res)
        plain[f"b{res}"] = {"conv0": cells * 9 * ci * co, "conv1": res * res * 9 * co * co,
                            "torgb": res * res * co * cfg.img_channels}
    total = {name: sum(sum(b.values()) for b in d.values()) for name, d in (("s2d", s2d), ("plain", plain))}
    return {"s2d": s2d, "plain": plain, "s2d_total": total["s2d"], "plain_total": total["plain"],
            "ratio": total["s2d"] / total["plain"]}


def batch_median_ms(fn, n: int) -> float:
    """The median wall ms of n synchronised calls of fn, after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def quartiles(values):
    import numpy as np

    return [float(v) for v in np.percentile(values, [25, 50, 75])]


def route_inputs(model, batch: int, gen):
    """The inputs of one render batch of `batch` frames for the facade `model`: w latents, the noise pyramid
    and the motion, as synthesis keywords."""
    import torch

    ws = model.get_w_latents(f"0-{batch}")
    noises = model.make_noise_pyramid(torch.randn(batch, 1, 64, 64, generator=gen, device="cuda"))
    motion = dict(translation=torch.full((batch, 2), 0.05, device="cuda"),
                  zoom=torch.full((batch,), 0.9, device="cuda"), rotation=torch.full((batch,), 3.0, device="cuda"))
    return ws, dict(noises=noises, **motion)


def route_pair(model, batch: int, gen):
    """The s2d and plain routes of the facade `model` as zero-argument calls
    on one batch of `batch` frames with the noise pyramid and the motion a
    render batch has."""
    from maua_tpu_torch.gan.wrappers import synthesize

    ws, kw = route_inputs(model, batch, gen)
    fast = model._get_fast()
    return {"s2d": lambda: fast(ws, noise_mode="const", rcfg=model.rcfg, **kw),
            "plain": lambda: synthesize(model.params, ws, model.cfg, model.rcfg, **kw)}


def route_ab(routes, batch: int, pairs: int, base: str = "plain", new: str = "s2d") -> dict:
    """fps of the two routes in turns (base first, then new first: P N N P P
    N ...), each turn the median of S2D_AB_BATCHES batches; their quartiles,
    the ratio of the medians and whether new's median lies below base's by
    more than base's quartile spread."""
    import torch

    turns = []
    with torch.no_grad():
        for i in range(pairs):
            turn = {}
            for name in ((base, new) if i % 2 == 0 else (new, base)):
                turn[name] = batch / batch_median_ms(routes[name], S2D_AB_BATCHES) * 1e3
            turns.append(turn)
    q = {name: quartiles([t[name] for t in turns]) for name in routes}
    return {"fps_pairs": turns, "fps_quartiles": q, f"{new}_over_{base}": q[new][1] / q[base][1],
            f"{new}_loses_beyond_spread": q[new][1] < q[base][1] - (q[base][2] - q[base][0])}


def run_fast():
    """The space-to-depth route of StyleGAN2 synthesis at config-f 1024^2
    (seed-0 weights): plan seconds (the facade's first s2d call builds it),
    the epilogue's launches in one batch on each route, multiply-adds, card
    vs CPU and s2d vs plain for one f32 frame with TF32 off, and the A/B of
    the two routes at batch 8 with bf16 top resolutions (noise pyramid and
    motion as a render batch has them), in turns, with one profiled batch
    of each; then the same A/B for an f32 facade (TF32 as torch sets it),
    at batch 1, and for a 512^2 net (only b512 on cells)."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan import fast_synthesis as FS
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.gan.wrappers import StyleGAN2, synthesize
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.utility import to_device

    model = StyleGAN2(device="cuda", seed=0)
    t0 = time.perf_counter()
    fast = model._get_fast()  # probe and convert, as the first render does
    torch.cuda.synchronize()
    plan_seconds = time.perf_counter() - t0
    if not fast or sorted(model._fast_plan["blocks"]) != s2d_blocks(model.cfg):
        raise AssertionError(f"the facade's plan covers {sorted((model._fast_plan or {}).get('blocks', []))}, "
                             f"want {s2d_blocks(model.cfg)}")
    macs = tail_macs(model._fast_plan, model.cfg)

    gen = torch.Generator(device="cuda").manual_seed(2)
    routes = route_pair(model, BATCH, gen)
    launches = {}
    with torch.no_grad():
        bf16_psnr = psnr_db(routes["s2d"]().cpu().numpy(), routes["plain"]().cpu().numpy(), 2.0)
        for name in routes:
            with epilogue_cases_recorded() as cases:
                E.reset_launches()
                routes[name]()
                torch.cuda.synchronize()
                launches[name] = {"launches": E.launches, "on_cells": cases["cells"].total(),
                                  "plain_shapes": plain_shape_counts(cases["plain"], model.cfg)}
    n_cells = 2 * len(s2d_blocks(model.cfg))
    if launches["s2d"]["launches"] != 17 or launches["s2d"]["on_cells"] != n_cells or \
            launches["plain"]["launches"] != 17 or launches["plain"]["on_cells"] != 0 or \
            any(n != 2 for n in launches["plain"]["plain_shapes"].values()):
        raise AssertionError(f"epilogue launches of one batch: {launches}, want 17 each, {n_cells} on cells on s2d, "
                             f"none on cells and 2 at each plain b512 / b1024 shape on plain")
    ab = route_ab(routes, BATCH, S2D_AB_PAIRS)

    def to_uint8(img):
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu()

    breakdown = {name: profile_batch(lambda fn=fn: to_uint8(fn()), "epilogue") for name, fn in routes.items()}
    del routes
    torch.cuda.empty_cache()

    # the same A/B where the bf16 batch-8 1024^2 turn does not speak for the route: an f32 facade (its cell
    # convs carry 4x the multiply-adds in f32 / TF32), batch 1 (the realtime viewer's), a 512^2 net
    others = {}
    for label, kw, batch in (("f32_b8", dict(dtype="float32"), BATCH), ("bf16_b1", {}, 1),
                             ("512_bf16_b8", dict(img_resolution=512), BATCH)):
        other = StyleGAN2(cfg=SG2Config(**kw), device="cuda", seed=0)
        others[label] = route_ab(route_pair(other, batch, gen), batch, S2D_AB_OTHER_PAIRS)
        others[label]["s2d_blocks"] = sorted(other._fast_plan["blocks"])
        del other
        torch.cuda.empty_cache()

    # one f32 frame: s2d on the card, the plain route on the card, s2d on the CPU
    with tf32_off(), torch.no_grad():
        cfg32 = SG2Config(dtype="float32")
        card = StyleGAN2(cfg=cfg32, device="cuda", seed=0)
        card._get_fast()
        params_cpu = to_device(card.params, "cpu")
        w1 = card.get_w_latents("7")
        noise1 = card.make_noise_pyramid(torch.randn(1, 1, 64, 64, generator=gen, device="cuda"))
        kw = dict(translation=torch.tensor([[0.05, 0.0]]), zoom=torch.tensor([0.9]), rotation=torch.tensor([3.0]))
        on_card = {k: v.cuda() for k, v in kw.items()}
        plan = card._fast_plan
        a = FS.synthesis_fast(card.params, FS.device_plan(plan, cfg32, "cuda"), w1, cfg32, noise_mode="const",
                              noises=noise1, **on_card)
        b = synthesize(card.params, w1, cfg32, card.rcfg, noises=noise1, **on_card)
        t0 = time.perf_counter()
        c = FS.synthesis_fast(params_cpu, FS.device_plan(plan, cfg32, "cpu"), w1.cpu(), cfg32, noise_mode="const",
                              noises={k: v.cpu() for k, v in noise1.items()}, **kw)
        cpu_seconds = time.perf_counter() - t0
    a, b, c = (x.cpu().numpy() for x in (a, b, c))
    f32 = {"card_vs_cpu_psnr_db": psnr_db(a, c, 2.0), "s2d_vs_plain_psnr_db": psnr_db(a, b, 2.0),
           "card_vs_cpu_max_abs": float(np.abs(a - c).max()), "s2d_vs_plain_max_abs": float(np.abs(a - b).max()),
           "cpu_seconds": cpu_seconds}
    if min(f32["card_vs_cpu_psnr_db"], f32["s2d_vs_plain_psnr_db"]) < 40.0:
        raise AssertionError(f"s2d f32 frame: {f32}")
    q = ab["fps_quartiles"]
    return {"plan_seconds": plan_seconds, "epilogue_launches_per_batch": launches, "macs_per_frame": macs,
            "bf16_s2d_vs_plain_psnr_db": bf16_psnr, **ab,
            "faster_route": "s2d" if q["s2d"][1] >= q["plain"][1] else "plain",
            "breakdown": breakdown, "other_ab": others, "f32_frame": f32}


INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core operations per second
INT8_AB_PAIRS = 3  # int8 / bf16 pairs of each of the int8 phase's A/Bs, in the order P N N P P N
INT8_CARD_BAR = 40.0  # an int8 route card vs CPU on one plan, f32 with TF32 off: dB over the [-1, 1] range


def conv_i8_library(x, w):
    """The same integer function through one PyTorch integer matmul: F.unfold of x (in fp16, which holds
    int8 values exactly; PyTorch's unfold takes no int8) as int8 rows, channels padded to multiples of 8,
    times w by torch._int_mm, int32 (B, Co, H, W) as f32. None where _int_mm does not run."""
    import torch
    import torch.nn.functional as F

    b, ci, h, wd = x.shape
    co, _, k, _ = w.shape
    cip, cop = -(-ci // 8) * 8, -(-co // 8) * 8
    xp = F.pad(x, (0, 0, 0, 0, 0, cip - ci)) if cip != ci else x
    wp = torch.zeros(cop, cip, k, k, dtype=torch.int8, device=w.device)
    wp[:co, :ci] = w
    cols = F.unfold(xp.half(), k, padding=k // 2)  # (B, cip k k, H W)
    rows = cols.transpose(1, 2).reshape(b * h * wd, cip * k * k).to(torch.int8)
    y = torch._int_mm(rows, wp.reshape(cop, -1).t())  # (B H W, cop) int32
    return y[:, :co].reshape(b, h, wd, co).permute(0, 3, 1, 2).float()


def check_conv_i8(cases):
    """conv_i8 against its plain version (F.conv2d in float64 on the card, exact), bit for bit, at each case
    (label, B, Ci, H, W, Co, k) on random int8 tensors, with the all +-127 case at the widest K; the staging route
    the kernel took (CI.staging_route: "tma" or "cp.async"); ms (CUDA
    events) beside the bound: the larger of 2 B H W k^2 Ci Co operations at 1979 TOPS (dense int8) and x and
    w read once and y (f32) written once at 3.35 TB/s; the plain version's ms (one warm call); the library
    route (conv_i8_library: the same integer function, timed, unused by the port) and cuDNN's bf16
    F.conv2d at the same shape (a different function: bf16 operands, f32 accumulation), each timed only."""
    import torch
    import torch.nn.functional as F

    from maua_tpu_torch.kernels import conv_i8 as CI

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, b, ci, h, w, co, k in cases:
        x = torch.randint(-127, 128, (b, ci, h, w), generator=gen, device="cuda", dtype=torch.int8)
        wt = torch.randint(-127, 128, (co, ci, k, k), generator=gen, device="cuda", dtype=torch.int8)
        if label == "extreme":
            x.fill_(127)
            wt[co // 2 :] = -127
            wt[: co // 2] = 127
        out = CI.conv_i8(x, wt)
        ref = CI.conv_i8_plain(x, wt)
        err = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"conv_i8 {label} differs from its plain version: max abs err {err}")
        del ref
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        CI.conv_i8_plain(x, wt)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        ops = 2 * b * h * w * k * k * ci * co
        nbytes = x.numel() + wt.numel() + 4 * out.numel()
        ops_ms, bytes_ms = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        iters = 5 if ops > 1e12 else 20
        ms = cuda_time_ms(lambda: CI.conv_i8(x, wt), iters=iters)
        try:
            lib_equal = torch.equal(conv_i8_library(x, wt), out)
            library_ms = cuda_time_ms(lambda: conv_i8_library(x, wt), iters=3)
        except (RuntimeError, NotImplementedError) as e:  # _int_mm refuses the shape or the device
            lib_equal, library_ms = str(e).splitlines()[0][:120], None
        del out
        torch.cuda.empty_cache()
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        cudnn_bf16_ms = cuda_time_ms(lambda: F.conv2d(xb, wb, padding=k // 2), iters=iters)
        rows[label] = {"shape": [b, ci, h, w, co, k], "route": CI.staging_route(x), "bit_equal": True,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "library_equal": lib_equal, "cudnn_bf16_conv_ms": cudnn_bf16_ms,
                       "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                       "ops_ms": ops_ms, "bytes_ms": bytes_ms, "tops": ops / ms / 1e9, "share_of_bound":
                       max(ops_ms, bytes_ms) / ms}
        del x, wt, xb, wb
        torch.cuda.empty_cache()
    CI.reset_launches()  # the comparison launches do not count
    for label, r in rows.items():
        print(json.dumps({"conv_i8": {"case": label, **r}}), flush=True)
    return rows


def conv_i8_sums(rows, labels) -> dict:
    """The conv cases' times and bounds summed over `labels` (one launch each), the bound's kind by the larger
    share; library_ms None where a case has none."""
    out = {k: sum(rows[c][k] for c in labels) for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                                                          "cudnn_bf16_conv_ms")}
    libs = [rows[c]["library_ms"] for c in labels]
    out["library_ms"] = None if any(v is None for v in libs) else sum(libs)
    out["bound_by"] = "operations" if out["ops_ms"] >= out["bytes_ms"] else "bytes"
    out["routes"] = {r: sum(rows[c]["route"] == r for c in labels) for r in sorted({rows[c]["route"] for c in labels})}
    return out


def run_int8(reference):
    """The int8 (W8A8) plans on the card. StyleGAN2 config-f 1024^2 (seed-0 weights, bf16 top resolutions):
    make_fast_synthesis(int8=True) -> quantize_plan's calibration -> synthesis_fast with b512 and b1024 on
    int8 cells, one render batch of 8 (the fast phase's noise pyramid and motion): 17 epilogue launches (4 on
    cells, 2 of them int8-out) and 4 conv_i8. StyleGAN3 config T 1024^2 (seed 0, bf16 trunk): quantize_sg3
    -> synthesis(int8_plan=), one batch of 8: 13 filtered-lrelu and 13 conv_i8 launches. Any other count
    fails. conv_i8 is held bit-equal to its plain version at every conv of those two batches (and at all
    +-127), every epilogue case of the StyleGAN2 batch against its plain version (check_epilogue_cases; the
    int8-out ones within one code) and each filtered lrelu of the StyleGAN3 batch, on its own input, against
    the plain version (flrelu_agrees); each route's PSNR over [-1, 1] and SNR against the f32
    route (recorded, and again on a plan calibrated on the batch's own latents);
    card vs CPU on one plan, f32 with TF32 off, >= INT8_CARD_BAR (StyleGAN2 at 1024^2, batch 1;
    StyleGAN3 at 256^2 against sg3_reference_child's CPU frame on the plan it calibrated); an A/B in turns
    against the bf16 s2d route and the fused bf16 StyleGAN3 route, with one profiled batch of each."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan import fast_synthesis as FS
    from maua_tpu_torch.gan import stylegan3 as S3
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.gan.wrappers import StyleGAN2, synthesize
    from maua_tpu_torch.kernels import conv_i8 as CI
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.kernels import filtered_lrelu as FL
    from maua_tpu_torch.utility import to_device

    def to_uint8(img):
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu()

    # ---- StyleGAN2: the s2d tail on int8 cells
    model = StyleGAN2(device="cuda", seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn, plan = FS.make_fast_synthesis(model.params, model.cfg, int8=True)
    torch.cuda.synchronize()
    make_seconds = time.perf_counter() - t0
    first = {res: {k: e[k].copy() for k in ("q0", "q1", "s0", "s1", "a0", "a1")} for res, e in plan["blocks"].items()}
    t0 = time.perf_counter()
    FS.quantize_plan(model.params, plan, model.cfg)  # a recalibration: the calibration alone
    calibration_seconds = time.perf_counter() - t0
    recalibrated_equal = all(np.array_equal(plan["blocks"][r][k], v) for r, e in first.items() for k, v in e.items())
    gen = torch.Generator(device="cuda").manual_seed(2)
    ws, kw = route_inputs(model, BATCH, gen)
    bf16_fast = model._get_fast()
    sg2_routes = {"int8": lambda: fn(ws, noise_mode="const", rcfg=model.rcfg, **kw),
                  "bf16_s2d": lambda: bf16_fast(ws, noise_mode="const", rcfg=model.rcfg, **kw)}
    with torch.no_grad():
        sg2_routes["int8"]()  # warm-up: the comparison below counts one batch
        with epilogue_cases_recorded() as cases:
            E.reset_launches(), CI.reset_launches()
            img = sg2_routes["int8"]()
            torch.cuda.synchronize()
            sg2_launches = {"epilogue": E.launches, "on_cells": cases["cells"].total(), "int8_out": E.int8_launches,
                            "conv_i8": CI.launches}
        bf16_img = sg2_routes["bf16_s2d"]()
        with tf32_off():
            f32_img = synthesize(model.params, ws, SG2Config(dtype="float32"), model.rcfg, **kw)
    n_blocks = len(s2d_blocks(model.cfg))
    if sg2_launches != {"epilogue": 17, "on_cells": 2 * n_blocks, "int8_out": n_blocks, "conv_i8": 2 * n_blocks}:
        raise AssertionError(f"one int8 StyleGAN2 batch launched {sg2_launches}, want 17 epilogues ({2 * n_blocks} on "
                             f"cells, {n_blocks} int8-out) and {2 * n_blocks} conv_i8")
    if img.shape != (BATCH, 3, 1024, 1024) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the int8 StyleGAN2 batch: {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    epilogue_rows, _ = check_epilogue_cases(cases, "int8")  # every case of that batch, at its own shapes
    sg2 = {"make_fast_synthesis_seconds": make_seconds, "calibration_seconds": calibration_seconds,
           "recalibrated_plan_equal": recalibrated_equal, "launches": sg2_launches,
           "epilogue_cases": epilogue_rows,
           "psnr_vs_f32_db": psnr_db(img.cpu().numpy(), f32_img.cpu().numpy(), 2.0),
           "bf16_s2d_psnr_vs_f32_db": psnr_db(bf16_img.cpu().numpy(), f32_img.cpu().numpy(), 2.0),
           "snr_vs_f32_db": snr_db(img.cpu().numpy(), f32_img.cpu().numpy()),
           "bf16_s2d_snr_vs_f32_db": snr_db(bf16_img.cpu().numpy(), f32_img.cpu().numpy()),
           "f32_rms": float(f32_img.pow(2).mean().sqrt())}
    with torch.no_grad():  # the same batch on a plan calibrated on its own latents: what the calibration's draw costs
        own = FS.quantize_plan(model.params, FS.build_fast_plan(model.params, model.cfg), model.cfg, ws=ws)
        own_img = FS.synthesis_fast(model.params, FS.device_plan(own, model.cfg, "cuda"), ws, model.cfg,
                                    noise_mode="const", rcfg=model.rcfg, **kw)
    sg2["own_latents_psnr_vs_f32_db"] = psnr_db(own_img.cpu().numpy(), f32_img.cpu().numpy(), 2.0)
    sg2["own_latents_snr_vs_f32_db"] = snr_db(own_img.cpu().numpy(), f32_img.cpu().numpy())
    del img, bf16_img, f32_img, own_img
    cases_sg2 = []
    for res, e in sorted(FS.device_plan(plan, model.cfg, "cpu")["blocks"].items()):
        convs = ((e["q0"], model.cfg.channels(res // 2)), (e["q1"], 4 * model.cfg.channels(res)))
        for conv, (q, ci) in enumerate(convs):
            if q.shape[1] != ci or q.shape[2] != q.shape[3]:
                raise AssertionError(f"b{res} q{conv}: {tuple(q.shape)}")
            cases_sg2.append((f"sg2-b{res}-conv{conv}", BATCH, ci, res // 2, res // 2, q.shape[0], q.shape[2]))
    sg2["ab"] = route_ab(sg2_routes, BATCH, INT8_AB_PAIRS, base="bf16_s2d", new="int8")
    sg2["profiles"] = {name: profile_batch(lambda f=f: to_uint8(f()), "conv_i8") for name, f in sg2_routes.items()}
    del sg2_routes, bf16_fast, fn
    model._fast_synth = None
    release_memory()

    # one f32 frame with noise and motion on one plan (calibrated on the card), card vs CPU, TF32 off
    with tf32_off(), torch.no_grad():
        cfg32 = SG2Config(dtype="float32")
        fn32, plan32 = FS.make_fast_synthesis(model.params, cfg32, int8=True)
        w1 = model.get_w_latents("7")
        noise1 = model.make_noise_pyramid(torch.randn(1, 1, 64, 64, generator=gen, device="cuda"))
        motion1 = dict(translation=torch.tensor([[0.05, 0.0]]), zoom=torch.tensor([0.9]), rotation=torch.tensor([3.0]))
        card = fn32(w1, noise_mode="const", noises=noise1, rcfg=model.rcfg, **{k: v.cuda() for k, v in motion1.items()})
        t0 = time.perf_counter()
        host = FS.synthesis_fast(to_device(model.params, "cpu"), FS.device_plan(plan32, cfg32, "cpu"), w1.cpu(), cfg32,
                                 noise_mode="const", noises={k: v.cpu() for k, v in noise1.items()}, rcfg=model.rcfg,
                                 **motion1)
        sg2["card_vs_cpu"] = {"psnr_db": psnr_db(card.cpu().numpy(), host.numpy(), 2.0),
                              "max_abs": float((card.cpu() - host).abs().max()), "cpu_seconds": time.perf_counter() - t0}
    if sg2["card_vs_cpu"]["psnr_db"] < INT8_CARD_BAR:
        raise AssertionError(f"the int8 StyleGAN2 frame card vs CPU: {sg2['card_vs_cpu']}")
    del model, fn32, card, host
    release_memory()

    # ---- StyleGAN3: the trunk on int8 convs
    cfg3 = S3.SG3Config(dtype="bfloat16")
    model3 = S3.StyleGAN3(cfg=cfg3, device="cuda", seed=0)
    ws3 = model3.mapper(model3.get_z_latents(f"0-{BATCH}"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan3 = S3.quantize_sg3(model3.params, cfg3)
    torch.cuda.synchronize()
    sg3 = {"calibration_seconds": time.perf_counter() - t0}
    sg3_routes = {"int8": lambda: S3.synthesis(model3.params, ws3, cfg3, int8_plan=plan3),
                  "fused_bf16": lambda: S3.synthesis(model3.params, ws3, cfg3)}
    flrelu_rows = []

    def flrelu_checked(y, up_f, down_f, up, down, crop=None, **kw):
        # the kernel's output on the batch's own input against the plain version's
        out = FL.filtered_lrelu(y, up_f, down_f, up, down, crop=crop, **kw)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # check_flrelu's plain convs, full f32
            ref = FL.filtered_lrelu_plain(y, up_f, down_f, up, down, crop=crop, **kw)
        ok, err = flrelu_agrees(out, ref)
        flrelu_rows.append({"shape": list(y.shape), "dtype": str(y.dtype).removeprefix("torch."), "up": up,
                            "crop": crop, "affines": sorted(kw), "max_abs_err": err})
        if not ok:
            raise AssertionError(f"the int8 StyleGAN3 batch: the filtered lrelu disagrees with its plain version at "
                                 f"{flrelu_rows[-1]}")
        return out

    with torch.no_grad():
        sg3_routes["int8"]()
        FL.reset_launches(), CI.reset_launches()
        wrapper, S3.filtered_lrelu = S3.filtered_lrelu, flrelu_checked
        try:
            img = sg3_routes["int8"]()
        finally:
            S3.filtered_lrelu = wrapper
        torch.cuda.synchronize()
        sg3["launches"] = {"filtered_lrelu": FL.launches, "conv_i8": CI.launches}
        sg3["filtered_lrelu_cases"] = flrelu_rows
        bf16_img = sg3_routes["fused_bf16"]()
        with tf32_off():
            f32_img = S3.synthesis(model3.params, ws3, S3.SG3Config(dtype="float32"))
    n3 = cfg3.num_layers - 1
    if sg3["launches"] != {"filtered_lrelu": n3, "conv_i8": n3}:
        raise AssertionError(f"one int8 StyleGAN3 batch launched {sg3['launches']}, want {n3} of each")
    if img.shape != (BATCH, 3, 1024, 1024) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the int8 StyleGAN3 batch: {tuple(img.shape)}, finite {bool(torch.isfinite(img).all())}")
    sg3["psnr_vs_f32_db"] = psnr_db(img.cpu().numpy(), f32_img.cpu().numpy(), 2.0)
    sg3["fused_bf16_psnr_vs_f32_db"] = psnr_db(bf16_img.cpu().numpy(), f32_img.cpu().numpy(), 2.0)
    sg3["snr_vs_f32_db"] = snr_db(img.cpu().numpy(), f32_img.cpu().numpy())
    sg3["fused_bf16_snr_vs_f32_db"] = snr_db(bf16_img.cpu().numpy(), f32_img.cpu().numpy())
    sg3["f32_rms"] = float(f32_img.pow(2).mean().sqrt())
    with torch.no_grad():
        own_img = S3.synthesis(model3.params, ws3, cfg3, int8_plan=S3.quantize_sg3(model3.params, cfg3, ws=ws3))
    sg3["own_latents_psnr_vs_f32_db"] = psnr_db(own_img.cpu().numpy(), f32_img.cpu().numpy(), 2.0)
    sg3["own_latents_snr_vs_f32_db"] = snr_db(own_img.cpu().numpy(), f32_img.cpu().numpy())
    del img, bf16_img, f32_img, own_img
    _, _, _, _, sizes, _ = cfg3.layer_plan()
    cases_sg3 = []
    for i in range(n3):
        co, ci, k, _ = plan3[f"L{i}"]["q"].shape
        cases_sg3.append((f"sg3-L{i}", BATCH, ci, int(sizes[i]), int(sizes[i]), co, k))
    sg3["ab"] = route_ab(sg3_routes, BATCH, INT8_AB_PAIRS, base="fused_bf16", new="int8")
    sg3["profiles"] = {name: profile_batch(lambda f=f: f().cpu(), "conv_i8") for name, f in sg3_routes.items()}
    del sg3_routes, model3, plan3, ws3
    release_memory()

    # the 256^2 f32 frame on the plan that sg3_reference_child calibrated on the CPU, card vs CPU
    ref, wait_s = sg3_reference_result(reference)
    cfg256 = S3.SG3Config(img_resolution=256, dtype="float32")
    plan256 = {f"L{i}": {k: torch.from_numpy(ref[f"int8_L{i}_{k}"]) for k in ("q", "s", "a")}  # q in OIHW
               for i in range(cfg256.num_layers - 1)}
    with tf32_off(), torch.no_grad():
        params256 = to_device(S3.StyleGAN3(cfg=cfg256, device="cpu", seed=0).params, "cuda")
        card = S3.synthesis(params256, torch.from_numpy(ref["w"]).cuda(), cfg256,
                            int8_plan=S3.int8_plan_to_device(plan256, "cuda"))
    sg3["card_vs_cpu"] = {"psnr_db": psnr_db(card.cpu().numpy(), ref["int8_image"], 2.0),
                          "max_abs": float(np.abs(card.cpu().numpy() - ref["int8_image"]).max()),
                          "cpu_calibration_seconds": float(ref["int8_calibration_seconds"]),
                          "cpu_seconds": float(ref["int8_seconds"]), "cpu_reference_wait_seconds": wait_s}
    if sg3["card_vs_cpu"]["psnr_db"] < INT8_CARD_BAR:
        raise AssertionError(f"the int8 StyleGAN3 frame card vs CPU: {sg3['card_vs_cpu']}")
    del params256, card
    release_memory()

    # the kernels at the shapes of those two batches
    # conv_i8 at the shapes of those two batches
    conv_rows = check_conv_i8(cases_sg2 + cases_sg3 + [("extreme", 1, 512, 36, 36, 64, 3)])
    print(json.dumps({"int8_ab": {"sg2_int8_over_bf16_s2d": sg2["ab"]["int8_over_bf16_s2d"],
                                  "sg3_int8_over_fused_bf16": sg3["ab"]["int8_over_fused_bf16"],
                                  "fps_quartiles": {"sg2": sg2["ab"]["fps_quartiles"], "sg3": sg3["ab"]["fps_quartiles"]}}}),
          flush=True)
    return {"sg2": sg2, "sg3": sg3, "conv_i8_sg2_batch": conv_i8_sums(conv_rows, [c[0] for c in cases_sg2]),
            "conv_i8_sg3_batch": conv_i8_sums(conv_rows, [c[0] for c in cases_sg3]),
            "conv_i8_max_abs_err": max(r["max_abs_err"] for r in conv_rows.values())}


GAN_GENERATE_IMAGES = 2  # PNGs of each `gan generate` sampling (cut from 8 for time)


def run_gan_generate(tmp: str):
    """`python -m maua_tpu_torch gan generate` (the command's main, in this
    process) at 1024^2 from seed-0 weights: GAN_GENERATE_IMAGES PNGs by each of random,
    polarity and jacnorm sampling, and two StyleGAN3 frames resized to
    1920 x 1080."""
    import numpy as np
    from PIL import Image

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.kernels import filtered_lrelu as FL

    out = {}
    runs = [(s, ["--sampling", s, "--seeds", f"0-{GAN_GENERATE_IMAGES}"], (1024, 1024), GAN_GENERATE_IMAGES, E)
            for s in ("random", "polarity", "jacnorm")]
    runs.append(("stylegan3", ["--architecture", "stylegan3", "--seeds", "0-2", "--out_size", "1920,1080"],
                 (1920, 1080), 2, FL))
    for name, args, size, n, kernel in runs:
        out_dir = os.path.join(tmp, f"gan_{name}")
        kernel.reset_launches()
        t0 = time.perf_counter()
        command.main(["gan", "generate", *args, "--out_dir", out_dir])
        seconds = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir))
        imgs = [np.asarray(Image.open(os.path.join(out_dir, f))) for f in files]
        if len(files) != n or any(im.shape != (size[1], size[0], 3) or im.min() == im.max() for im in imgs):
            raise AssertionError(f"gan generate {name}: {files}, {[im.shape for im in imgs]}")
        distinct = len({im.tobytes() for im in imgs})
        # polarity sampling may draw one probe latent many times (its weights are a softmax of log-volumes)
        if distinct < (1 if name == "polarity" else n):
            raise AssertionError(f"gan generate {name}: {distinct} distinct images of {n}")
        out[name] = {"command_seconds": seconds, "pngs": len(files), "distinct": distinct, "size": list(size),
                     "launches": kernel.launches}
    return out


UMX_TOL = 1e-3  # card vs CPU stems, peak ~0.9: cuDNN's LSTM and cuFFT against the CPU's, TF32 off
UMX_REFERENCE_SECONDS = 5.0  # cut from 10 for time


def run_umx(song: str):
    """The openunmix-style separator at the full UMXConfig, random-init from
    seed 0, over the 180 s song on the card (cold and warm seconds); the
    stems' sum against the mixture's bins; card vs CPU stems over its first
    10 s with TF32 off."""
    import numpy as np
    import torch

    from maua_tpu_torch.audio import separate as U
    from maua_tpu_torch.audio import spectral
    from maua_tpu_torch.audio.io import load_audio

    y, sr, _ = load_audio(song)
    cfg = U.UMXConfig()
    params = U.init_params(cfg, device="cuda")
    yt = torch.from_numpy(y).cuda()
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stems = U.separate(yt, sr, params=params, cfg=cfg)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    total = torch.stack(stems).sum(0)
    if any(s.shape != yt.shape or not bool(s.isfinite().all()) for s in stems):
        raise AssertionError("umx stems: shape or finiteness")
    # the EM masks sum to 1 on every bin that some network claims with a magnitude above the 1e-10 floor of
    # their sum, and to 0 where all four relu masks are 0; the stems sum to the mixture's iSTFT through that
    # mask sum, and to the mixture itself on the claimed bins
    with torch.no_grad():
        D = spectral.stft(yt, n_fft=cfg.n_fft, hop_length=cfg.hop_length)
        mask_sum = U._separate_masks(params, D.abs().T, cfg).sum(0).T
        kept = spectral.istft(D * mask_sum, n_fft=cfg.n_fft, hop_length=cfg.hop_length, length=yt.shape[0])
    loud = D.abs() > 1e-3 * D.abs().max()
    off = ((mask_sum[loud] - 1).abs().clamp_max((mask_sum[loud]).abs()))
    sum_err = float((total - kept).abs().max())
    if float(mask_sum.max()) > 1 + 1e-4 or float(mask_sum.min()) < 0 or float(off.max()) > 1e-4 or sum_err > 1e-4:
        raise AssertionError(f"umx masks sum to [{float(mask_sum.min())}, {float(mask_sum.max())}], loud bins "
                             f"{float(off.max())} from 0 or 1; stems sum {sum_err} from the masked mixture")
    claimed = float((mask_sum[loud] > 0.5).float().mean())
    mix_snr = 10 * math.log10(float(yt.square().sum()) / max(float((total - yt).square().sum()), 1e-20))

    n = int(UMX_REFERENCE_SECONDS * sr)
    with tf32_off():
        card = [s.cpu().numpy() for s in U.separate(yt[:n], sr, params=params, cfg=cfg)]
        t0 = time.perf_counter()
        cpu = [s.numpy() for s in U.separate(torch.from_numpy(y[:n]), sr,
                                              params={t: {k: v.cpu() for k, v in p.items()} for t, p in params.items()},
                                              cfg=cfg)]
        cpu_seconds = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    if err > UMX_TOL:
        raise AssertionError(f"umx card vs CPU stems differ by {err} > {UMX_TOL}")
    return {"song_seconds": len(y) / sr, "seconds_cold": seconds[0], "seconds_warm": seconds[1],
            "frames": int(D.shape[-1]), "stems_sum_vs_masked_mixture_max_abs": sum_err,
            "loud_bins_unclaimed_share": 1 - claimed, "stems_sum_vs_mixture_snr_db": mix_snr,
            "card_vs_cpu_max_abs": err, "cpu_seconds_10s": cpu_seconds}


SG3_REFERENCE_THREADS = 4  # the CPU reference frame's process runs beside the card's phases on these cores


def sg3_reference_child(path: str):
    """The CPU side of sg3_resize's and int8's card-vs-CPU frames, in its own process: the StyleGAN3 facade at
    256^2, f32, seed 0 (parameters drawn on the CPU), output 480 x 270; the w of seed 7 and its frame; then an
    int8 plan calibrated on that w (quantize_sg3) and the int8 synthesis of it, written to `path` (.npz: the
    plan as int8_L{i}_{q,s,a}, q in OIHW)."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config, StyleGAN3, quantize_sg3, synthesis

    torch.set_num_threads(SG3_REFERENCE_THREADS)
    cfg = SG3Config(img_resolution=256, dtype="float32")
    cpu = StyleGAN3(cfg=cfg, device="cpu", seed=0, output_size=(480, 270))
    w1 = cpu.mapper(cpu.get_z_latents("7"))
    t0 = time.perf_counter()
    frame = np.stack(list(cpu.render(w1)))
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = quantize_sg3(cpu.params, cfg, ws=w1)
    calibration_seconds = time.perf_counter() - t0
    with torch.no_grad():
        int8_image = synthesis(cpu.params, w1, cfg, int8_plan=plan)
    np.savez(path, w=w1.numpy(), frame=frame, seconds=seconds, int8_image=int8_image.numpy(),
             int8_calibration_seconds=calibration_seconds, int8_seconds=time.perf_counter() - t0,
             **{f"int8_{name}_{k}": v.numpy() for name, e in plan.items() for k, v in e.items()})


def start_sg3_reference(tmp: str):
    """Start sg3_reference_child at the start of the run, so that its ~4 minutes of CPU work overlap the card's
    phases: {"proc": the process, "path": its output}."""
    path = os.path.join(tmp, "sg3_reference.npz")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sg3-reference-child", path],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return {"proc": proc, "path": path}


def sg3_reference_result(reference):
    """sg3_reference_child's output (a dict of arrays) and the seconds this process waited for it: the first
    caller waits, later callers get the same."""
    import numpy as np

    if "result" not in reference:
        proc = reference["proc"]
        t0 = time.perf_counter()
        _, err = proc.communicate(timeout=900)
        reference["wait_seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"the StyleGAN3 reference process failed:\n{err[-4000:]}")
        with np.load(reference["path"]) as z:
            reference["result"] = dict(z)
    return reference["result"], reference["wait_seconds"]


def run_sg3_resize(reference):
    """The StyleGAN3 facade (config T, 1024^2, bf16 trunk, seed 0) rendering 8
    frames to 1920 x 1080; the resize of a native frame on the card against
    the CPU; one f32 frame at 256^2 resized to 480 x 270, card vs CPU with
    TF32 off (the CPU frame from sg3_reference_child's process, started with
    the run: the same seed-0 parameters and the same w)."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan.stylegan3 import SG3Config, StyleGAN3
    from maua_tpu_torch.kernels import filtered_lrelu as FL
    from maua_tpu_torch.ops import warp as W

    cfg = SG3Config(img_resolution=1024, dtype="bfloat16")
    model = StyleGAN3(cfg=cfg, device="cuda", seed=0, output_size=(1920, 1080))
    ws = model.mapper(model.get_z_latents(f"0-{BATCH}"))
    list(model.render(ws, batch_size=BATCH))  # warm-up
    FL.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = np.stack(list(model.render(ws, batch_size=BATCH)))
    seconds = time.perf_counter() - t0
    launches = FL.launches
    if frames.shape != (BATCH, 1080, 1920, 3) or launches != cfg.num_layers - 1:
        raise AssertionError(f"sg3_resize frames {frames.shape}, {launches} filtered-lrelu launches")
    native = model.synthesizer(ws[:1])
    resized_card = W.resize(native, (1080, 1920), "bilinear").cpu().numpy()
    resize_err = float(np.abs(resized_card - W.resize(native.cpu(), (1080, 1920), "bilinear").numpy()).max())

    ref, wait_s = sg3_reference_result(reference)
    with tf32_off():
        cfg256 = SG3Config(img_resolution=256, dtype="float32")
        params = StyleGAN3(cfg=cfg256, device="cpu", seed=0).params
        card = StyleGAN3(cfg=cfg256, params=params, device="cuda", output_size=(480, 270))
        a = np.stack(list(card.render(torch.from_numpy(ref["w"]).cuda())))
    b = ref["frame"]
    frame_psnr = psnr_db(a, b, 255.0)
    if a.shape != (1, 270, 480, 3) or frame_psnr < 40.0 or resize_err > 1e-4:
        raise AssertionError(f"sg3_resize: {a.shape}, PSNR {frame_psnr:.2f} dB, resize err {resize_err}")
    return {"frames": list(frames.shape), "render_seconds": seconds, "fps": BATCH / seconds, "launches": launches,
            "resize_card_vs_cpu_max_abs": resize_err, "f32_256_to_480x270_psnr_db": frame_psnr,
            "cpu_reference_seconds": float(ref["seconds"]), "cpu_reference_wait_seconds": wait_s}


def run_noise_patch(wav: str, repo: str):
    """The noise-parameterization example patch over the 3 s wav at 1024^2
    (seed-0 weights) into the memmap renderer: its noise pyramid reaches
    b512.conv0, inside the s2d tail, as per-frame cell noise."""
    return render_s2d_video(wav, example_patch(repo, "noise_parameterization.py"))


REALTIME_FRAMES = 48


def run_realtime():
    """The realtime viewer's random walk through the StyleGAN2 facade
    (config-f 1024^2, bf16 top resolutions, seed 0) into a callback:
    REALTIME_FRAMES frames and their rate (paced at 1000 fps, so the render
    sets it)."""
    import numpy as np
    import torch

    from maua_tpu_torch.audiovisual.realtime import run_realtime as viewer
    from maua_tpu_torch.gan.wrappers import StyleGAN2

    model = StyleGAN2(device="cuda", seed=0)
    model.synthesizer(model.get_w_latents("0"))  # warm-up: builds the s2d plan
    seen = []
    t0 = time.perf_counter()
    shown = viewer(model.synthesizer, model.num_ws, model.w_dim, frame_callback=seen.append,
                   max_frames=REALTIME_FRAMES, target_fps=1000.0, gen=torch.Generator(device="cuda").manual_seed(0))
    seconds = time.perf_counter() - t0
    if shown != REALTIME_FRAMES or any(f.shape != (1024, 1024, 3) for f in seen) or np.array_equal(seen[0], seen[-1]):
        raise AssertionError(f"realtime: {shown} frames shown")
    return {"frames": shown, "walk_seconds": seconds, "fps": shown / seconds}


SS_KS = (2, 4, 6, 8, 12, 16)  # retrieve_music_information's default granularities
SS_REFERENCE_SECONDS = 20.0
# card vs CPU, f32 with TF32 off: MIR envelopes in [0, 1] as ar_reference's bar; a realization's latents and
# noise windows (values ~1; a Loop's phase magnifies the two devices' cos roundings up to 50-fold)
SS_TOL = 1e-4
INTERACTIVE_SECONDS = 8.0
INTERACTIVE_LAYOUT = {0.0: 0, 2.0: 1, 4.0: 0}  # the second 0 lasts 4 s, its patch (the first 0's) 2 s
INTERACTIVE_SCRIPT = ("1,3,5,7", "next", "2,9", "next")
AV_FRAMES = 24  # frames of the ss_e2e clip (1 s of its 72) whose descriptors av_correlation computes (cut for time)
# frames of the ss_e2e clip whose features the CPU also computes (Farneback is ~0.4 s a pair; cut from 12 for time)
AV_REFERENCE_FRAMES = 6


def ss_mir_child(song: str):
    """Run in a fresh process: retrieve_music_information over the song on
    the card twice (the first pass pays every first-use cost), the mel
    launches of each by MEL_SHAPES case."""
    import torch

    from maua_tpu_torch.audio.io import load_audio
    from maua_tpu_torch.audiovisual.selfsupervised.mir import beat_grid, retrieve_music_information
    from maua_tpu_torch.kernels import spectrogram as M

    audio, sr, duration = load_audio(song)
    y = torch.from_numpy(audio).cuda()
    passes = []
    for _ in range(2):
        M.reset_launches()
        with mel_cases_recorded() as cases:
            t0 = time.perf_counter()
            feats, segs, tempo = retrieve_music_information(y, sr, ks=SS_KS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        passes.append({"seconds": seconds, "mel_launches": M.launches,
                       "mel_cases": case_counts(cases, M.launches, "ss_mir")})
    t = int(next(iter(feats.values())).shape[0])
    return {"audio_seconds": duration, "cold": passes[0], "warm": passes[1], "tempo": tempo, "frames": t,
            "beats": len(beat_grid(t, tempo, sr)), "segmentations": len(segs),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def same_labels(a, b) -> bool:
    """Equal up to relabelling."""
    a, b = list(a), list(b)
    return len(set(zip(a, b))) == len(set(a)) == len(set(b))


def kmeans_replay(X, k: int, n_iter: int = 50) -> dict:
    """segment.kmeans of the card's rows X, replayed step by step on the card
    and on the CPU from the same starting rows, the CPU taking the card's
    assignment at each step: every point the two assign differently must
    be a tie on the CPU's own distances, its two distances within
    4 n eps(f32) (the CPU's centre is a mean of up to n unit rows, so it
    may lie n eps from the card's, and a squared distance between unit rows
    is at most 4). Returns the card's labels, the assignments that
    differed, the widest such margin, and whether all were ties."""
    import torch

    from maua_tpu_torch.audio import segment as Sg

    host = X.cpu()
    bound = 4 * X.shape[0] * torch.finfo(torch.float32).eps
    start = Sg.kmeans_init(X.shape[0], k)
    card_c, host_c = X[start.to(X.device)], host[start]
    flips, widest = 0, 0.0
    for step in range(n_iter + 1):
        card_a = Sg.kmeans_distances(X, card_c).argmin(dim=1)
        d = Sg.kmeans_distances(host, host_c)
        a, b = card_a.cpu(), d.argmin(dim=1)
        rows = (a != b).nonzero()[:, 0]
        if len(rows):
            flips += len(rows)
            widest = max(widest, float((d[rows, a[rows]] - d[rows, b[rows]]).abs().max()))
        if step < n_iter:
            card_c, host_c = Sg.kmeans_centers(X, card_a, k), Sg.kmeans_centers(host, a, k)
    return {"labels": a.numpy(), "differing_assignments": flips, "widest_margin": widest, "tie_bound": bound,
            "all_ties": widest <= bound}


def card_labelling_witness(card_feature, cpu_feature, beats, k: int, card_labels) -> dict:
    """Why a labelling at k differs between the card and the CPU, and a
    witness that sides with the card: the card's stages, run again, give
    its segmentation; its first k eigenpairs solve the CPU's own Laplacian
    (residual max |L v - lambda v| <= SS_TOL), so they are an eigenbasis of
    the CPU's matrix as valid as the one the CPU's eigh returned; and on
    the card's embedding the CPU's k-means steps assign as the card's do but
    at ties (kmeans_replay). Then the card's labelling is what the CPU's
    code gives for that basis when its f32 ties break the card's way. Also
    the eigen-gap at k and the closest pair of k-means' starting rows (two
    rows that coincide are centres every point is equally near)."""
    import numpy as np
    import torch

    from maua_tpu_torch.audio import segment as Sg
    from maua_tpu_torch.audiovisual.selfsupervised import mir

    grid, _, evals, evecs = mir.laplacian_eigen(card_feature, beats, SS_KS)
    _, L_cpu, _, _ = mir.laplacian_eigen(cpu_feature, beats, SS_KS)
    X = mir.embedding(evecs, k)
    replay = kmeans_replay(X, k)
    reproduced = bool(np.array_equal(mir.frame_labels(replay.pop("labels"), grid, card_feature.shape[0]),
                                     card_labels))
    V, lam = evecs[:, :k].cpu(), evals[:k].cpu()
    residual = float((L_cpu @ V - V * lam[None]).abs().max())
    start = X[Sg.kmeans_init(X.shape[0], k).to(X.device)]
    closest = torch.cdist(start, start) + torch.eye(k, device=X.device) * 1e9
    return {"eigen_gap": float(evals[k] - evals[k - 1]), "closest_start_rows": float(closest.min()),
            "stages_reproduce_card_labels": reproduced, "residual_on_cpu_laplacian": residual, **replay,
            "witness": reproduced and residual <= SS_TOL and replay["all_ties"]}


def mir_card_vs_cpu(audio, sr: int) -> dict:
    """retrieve_music_information of a signal on the card (TF32 off) and on
    the CPU: per-feature max abs errors, tempos, the raw spectral contrast's
    largest value in dB on each device, and each segmentation that does not
    agree up to relabelling, with card_labelling_witness."""
    import torch

    from maua_tpu_torch.audiovisual.selfsupervised import mir
    from maua_tpu_torch.audiovisual.selfsupervised.features import extract_features

    with tf32_off():
        card = mir.retrieve_music_information(torch.from_numpy(audio).cuda(), sr, ks=SS_KS)
        card_raw = extract_features(torch.from_numpy(audio).cuda(), sr)
    t0 = time.perf_counter()
    host = mir.retrieve_music_information(torch.from_numpy(audio), sr, ks=SS_KS)
    cpu_seconds = time.perf_counter() - t0
    host_raw = extract_features(torch.from_numpy(audio), sr)
    errs = {k: float((card[0][k].cpu() - host[0][k]).abs().max()) for k in host[0]}
    differ = {}
    with tf32_off():
        for (name, k), labels in host[1].items():
            if not same_labels(card[1][(name, k)], labels):
                beats = mir.beat_grid(card_raw[name].shape[0], card[2], sr)
                differ[f"{name}@{k}"] = card_labelling_witness(card_raw[name], host_raw[name], beats, k,
                                                               card[1][(name, k)])
    return {"max_abs_err": errs, "tempo": [card[2], host[2]], "segmentations": len(host[1]),
            "segmentations_differ": differ,
            "spectral_contrast_db_max": [float(card_raw["spectral_contrast"].max()),
                                         float(host_raw["spectral_contrast"].max())],
            "cpu_seconds": cpu_seconds}


def run_ss_mir(song: str):
    """retrieve_music_information over the 180 s song in a fresh process
    (ss_mir_child: cold, warm, 3 mel launches a call); then card vs CPU
    (mir_card_vs_cpu) over the song's first 20 s with a noise floor 30 dB
    below its peak, made from seed 3: features within AR_REFERENCE_TOL, the
    same tempo, and every segmentation equal up to relabelling or with a
    witness that sides with the card (card_labelling_witness). The bare
    song's first 20 s are compared and reported, not held: the synthetic
    song is digitally silent between its partials, so spectral contrast's
    valleys sit at the FFT's f32 roundoff (spectral_contrast_db_max), where
    the two devices' FFTs differ by orders of magnitude; music has a noise
    floor."""
    import numpy as np

    from maua_tpu_torch.audio.io import load_audio

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--ss-mir-child", song], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the ss_mir process failed:\n{proc.stderr[-4000:]}")
    song_out = json.loads(proc.stdout.strip().splitlines()[-1])
    song_out["process_seconds"] = time.perf_counter() - t0
    if song_out["cold"]["mel_launches"] != 3 or song_out["warm"]["mel_launches"] != 3:
        raise AssertionError(f"ss_mir: {song_out['cold']['mel_launches']}, {song_out['warm']['mel_launches']} mel "
                             f"launches a call, want 3 (onsets, mfcc, tempo; pulse is not among the features)")

    audio, sr, _ = load_audio(song, duration=SS_REFERENCE_SECONDS)
    bare = mir_card_vs_cpu(audio, sr)
    floor = 10 ** (-30 / 20) * float(np.abs(audio).max())
    floored = (audio + floor * np.random.RandomState(3).randn(len(audio))).astype(np.float32)
    ref = mir_card_vs_cpu(floored, sr)
    out = {"song": song_out, "reference_seconds": SS_REFERENCE_SECONDS, "bare": bare, "noise_floor": ref}
    if max(ref["max_abs_err"].values()) > AR_REFERENCE_TOL or ref["tempo"][0] != ref["tempo"][1] or \
            not all(v["witness"] for v in ref["segmentations_differ"].values()):
        raise AssertionError(f"ss_mir card vs CPU with a noise floor: {json.dumps(ref)}")
    return out


def run_ss_e2e(wav: str, tmp: str):
    """`selfsupervised.sample.generate` over the 3 s wav through the entry
    point at full width (config-f 1024^2 from seed-0 weights, bf16 top
    resolutions, batch 8, 24 fps, every one of the 17 layers' noise given),
    twice (the first builds the facade's s2d plan; the second is reported,
    the first's stages beside it): the facade's s2d route, so 153 epilogue
    launches, 36 of them on cells, each case of them held against the plain
    version (check_epilogue_cases); 3 mel launches (3s-h1024-m128); stage
    seconds, fps, peak memory, the patch's subpatches, the 72 frames read
    back. Then one batch's noise windows and its synthesis, each alone
    under torch.profiler: their device ms (the render's stage clock reads
    only host seconds and the intervals between CUDA events)."""
    import numpy as np
    import torch

    from maua_tpu_torch.audiovisual.selfsupervised import patch as P
    from maua_tpu_torch.audiovisual.selfsupervised import sample as S
    from maua_tpu_torch.gan.wrappers import layer_names
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.kernels import spectrogram as M
    from maua_tpu_torch.ops.video import read_video

    made, realized, gans = [], [], []
    patch_class, gan_class = P.Patch, S.StyleGAN2

    class Recorded(P.Patch):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def __call__(self, *args, **kwargs):
            realized.append(super().__call__(*args, **kwargs))
            return realized[-1]

    class RecordedGAN(S.StyleGAN2):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            gans.append(self)

    out_file, runs = os.path.join(tmp, "ss.mp4"), []
    torch.cuda.reset_peak_memory_stats()
    P.Patch, S.StyleGAN2 = Recorded, RecordedGAN
    try:
        for _ in range(2):  # the first pays the facade's s2d plan and the first use of the features' shapes
            stages = {}
            E.reset_launches()
            M.reset_launches()
            with epilogue_cases_recorded() as cases, mel_cases_recorded() as mel_cases:
                S.generate(wav, output_file=out_file, fps=FPS, seed=42, batch_size=BATCH, verbose=False,
                           device="cuda", stylegan_kwargs={"seed": 0}, stage_times=stages)
            runs.append(stages)
    finally:
        P.Patch, S.StyleGAN2 = patch_class, gan_class
    launches, mel_launches, cells = E.launches, M.launches, cases["cells"].total()
    n_frames = round(SECONDS * FPS)
    batches = math.ceil(n_frames / BATCH)
    video, _ = read_video(out_file)
    if launches != 17 * batches or cells != 4 * batches:
        raise AssertionError(f"ss_e2e: {launches} epilogue launches ({cells} on cells), want {17 * batches} "
                             f"({4 * batches})")
    if video.shape != (n_frames, 1024, 1024, 3) or video.min() == video.max() or np.all(video[0] == video[-1]):
        raise AssertionError(f"ss_e2e: read back {video.shape}, or constant frames")

    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30
    gan, (latents, noise_modules) = gans[-1], realized[-1]
    lat = latents[:BATCH] if latents.shape[1] == gan.num_ws else latents[:BATCH, :1].repeat(1, gan.num_ws, 1)
    noises = {name: mod(0, BATCH)[:, None] for name, mod in zip(layer_names(gan.cfg)[1:], noise_modules)}
    noise_profile = profile_batch(lambda: [mod(0, BATCH) for mod in noise_modules], "elementwise")
    synthesis_profile = profile_batch(lambda: gan.synthesizer(lat, noises=noises), "epilogue")
    noise_ms, synthesis_ms = noise_profile["device_ms"], synthesis_profile["device_ms"]
    share = noise_ms / (noise_ms + synthesis_ms) if all(isinstance(v, float) for v in (noise_ms, synthesis_ms)) \
        else "not measured"
    case_rows, worst = check_epilogue_cases(cases, "ss_e2e")
    patch = made[-1]
    return {"frames_read_back": int(video.shape[0]), "render_batches": batches, "launches": launches,
            "s2d_launches": cells, "epilogue_cases": case_rows, "epilogue_max_abs_err": worst,
            "mel_launches": mel_launches, "mel_cases": case_counts(mel_cases, mel_launches, "ss_e2e"),
            "stage_seconds_first": runs[0], "first_render_fps": n_frames / runs[0]["render"],
            "stage_seconds": stages,
            "noise_windows_host_ms_per_batch": 1e3 * stages["noise_windows"] / batches,
            "synthesis_host_ms_per_batch": 1e3 * stages["synthesis"] / batches,
            "noise_windows_interval_ms_per_batch": stages["noise_windows_interval_ms"] / batches,
            "synthesis_interval_ms_per_batch": stages["synthesis_interval_ms"] / batches,
            "noise_windows_profiled": noise_profile, "synthesis_profiled": synthesis_profile,
            "noise_share_of_device_ms": share,
            "render_fps": n_frames / stages["render"], "peak_mem_gib": peak_mem_gib,
            "latent_subpatches": len(patch.latent_patches), "noise_subpatches": len(patch.noise_patches),
            "output_file": out_file}


def host_draws(P):
    """A Draws whose tensors are drawn on the CPU and moved to the device, so a
    realization on the card and one on the CPU get the same draws."""

    class HostDraws(P.Draws):
        def __init__(self, seed, device):
            super().__init__(seed, "cpu")
            self.target = device

        def permutation(self, path, n):
            return super().permutation(path, n).to(self.target)

        def normal(self, path, shape):
            return super().normal(path, shape).to(self.target)

    return HostDraws


def run_ss_reference(wav: str):
    """One batch of a realization on the card and on the CPU, the draws made
    on the CPU, f32 with TF32 off: the latents and every one of the 17
    layers' noise windows of a config-f 1024^2 patch over the 3 s wav,
    max abs error <= SS_TOL; then one frame of a 256^2 f32 net (a bounded
    CPU time) with its patch's noise, PSNR >= 40 dB, and the epilogue held
    against its plain version at each of that frame's cases on the card."""
    import numpy as np
    import torch

    from maua_tpu_torch.audio.io import load_audio
    from maua_tpu_torch.audiovisual.selfsupervised import patch as P
    from maua_tpu_torch.audiovisual.selfsupervised.mir import retrieve_music_information
    from maua_tpu_torch.gan.stylegan2 import SG2Config
    from maua_tpu_torch.gan.wrappers import StyleGAN2, layer_names
    from maua_tpu_torch.ops.signal import resample_1d

    audio, sr, duration = load_audio(wav)
    n_frames = round(duration * FPS)
    feats, segs, tempo = retrieve_music_information(torch.from_numpy(audio).cuda(), sr)
    feats = {k: resample_1d(v, n_frames) for k, v in feats.items()}
    seg_t = next(iter(segs.values())).shape[0]
    frame_idx = np.clip((np.arange(n_frames) * seg_t / n_frames).astype(int), 0, seg_t - 1)
    segs = {k: np.asarray(v)[frame_idx] for k, v in segs.items()}
    draws = P.Patch.draws
    P.Patch.draws = lambda self, device: host_draws(P)(self.seed, device)

    def realize(model, seed):
        """The patch of `seed` over the wav, realized for `model`'s layers on
        the card and on the CPU from one palette (the model's mapper on the card)."""
        names = layer_names(model.cfg)[1:]
        sizes = [int(n.split(".")[0][1:]) for n in names]
        palette = model.mapper(P.seeded_normal(seed, (16, model.z_dim), "cpu").cuda())
        out = {}
        for device in ("cuda", "cpu"):
            patch = P.Patch({k: v.to(device) for k, v in feats.items()}, segs, tempo, fps=FPS, seed=seed)
            out[device] = patch(palette.to(device), noise_sizes=sizes)
        return names, out

    try:
        with tf32_off():
            card = StyleGAN2(device="cuda", seed=0, dtype="float32")
            names, out = realize(card, 42)
            (lat_c, noise_c), (lat_h, noise_h) = out["cuda"], out["cpu"]
            errs = {"latents": float((lat_c[:BATCH].cpu() - lat_h[:BATCH]).abs().max())}
            for name, mc, mh in zip(names, noise_c, noise_h):
                errs[name] = float((mc(0, BATCH).cpu() - mh(0, BATCH)).abs().max())
            del card, out, noise_c, noise_h
            torch.cuda.empty_cache()

            cfg = SG2Config(img_resolution=256, dtype="float32")
            net = StyleGAN2(cfg=cfg, device="cuda", seed=0)
            host = StyleGAN2(cfg=cfg, params=net.params, device="cpu")
            names, out = realize(net, 7)
            frames = []
            with epilogue_cases_recorded() as cases:
                for device, model in (("cuda", net), ("cpu", host)):
                    lat, noise = out[device]
                    img = model.synthesizer(lat[:1], noises={n: m(0, 1)[:, None] for n, m in zip(names, noise)})
                    frames.append(((img.clamp(-1, 1) + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy())
            case_rows, case_err = check_epilogue_cases(cases, "ss_reference")
    finally:
        P.Patch.draws = draws
    frame_psnr = psnr_db(frames[0], frames[1], 255.0)
    worst = max(errs.values())
    if worst > SS_TOL or frame_psnr < 40.0:
        raise AssertionError(f"ss_reference: max abs err {errs}, frame PSNR {frame_psnr:.2f} dB")
    return {"max_abs_err": worst, "by_layer": errs, "frame_256_psnr_db": frame_psnr, "epilogue_cases": case_rows,
            "epilogue_max_abs_err": case_err}


def run_interactive(tmp: str):
    """`generate_interactive` through the entry point over an 8 s wav with a
    scripted input (INTERACTIVE_SCRIPT: one `next` for each of the two
    unique sections) and the manual layout INTERACTIVE_LAYOUT, whose last
    bound is twice its patch's length: config-f 1024^2 (seed 0, bf16 top
    resolutions) to 512^2, batch 8. The output resize keeps the facade on
    the plain route: 192 frames read back, 24 batches, 408 epilogue
    launches, none on cells, each case of them held against the plain
    version (check_epilogue_cases)."""
    import numpy as np
    import torch

    from maua_tpu_torch.audiovisual import interactive as I
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.ops.video import read_video

    wav = os.path.join(tmp, "interactive.wav")
    synth_wav(wav, seconds=INTERACTIVE_SECONDS, seed=2)
    out_file, stages, printed, batches = os.path.join(tmp, "interactive.mp4"), {}, [], []
    script = iter(INTERACTIVE_SCRIPT)
    render_final = I.InteractiveSession.render_final

    def counted(self, *args, **kwargs):
        for batch in render_final(self, *args, **kwargs):
            batches.append(batch.shape[0])
            yield batch

    torch.cuda.reset_peak_memory_stats()
    E.reset_launches()
    I.InteractiveSession.render_final = counted
    try:
        with epilogue_cases_recorded() as cases:
            I.generate_interactive(wav, output_file=out_file, fps=FPS, seed=0, segmentation=INTERACTIVE_LAYOUT,
                                   batch_size=BATCH, out_size=(512, 512), stylegan_kwargs={"seed": 0},
                                   input_fn=lambda _: next(script), print_fn=printed.append, device="cuda",
                                   stage_times=stages)
    finally:
        I.InteractiveSession.render_final = render_final
    launches, cells = E.launches, cases["cells"].total()
    video, _ = read_video(out_file)
    n_frames = round(INTERACTIVE_SECONDS * FPS)
    if video.shape != (n_frames, 512, 512, 3) or len(batches) != 24 or launches != 17 * 24 or cells:
        raise AssertionError(f"interactive: read back {video.shape}, {len(batches)} batches, {launches} epilogue "
                             f"launches, {cells} on cells; want {n_frames} frames, 24, 408, 0")
    if video.min() == video.max() or np.all(video[0] == video[-1]):
        raise AssertionError("interactive: constant frames")
    case_rows, worst = check_epilogue_cases(cases, "interactive")
    return {"frames_read_back": int(video.shape[0]), "render_batches": len(batches), "launches": launches,
            "s2d_launches": cells, "epilogue_cases": case_rows, "epilogue_max_abs_err": worst,
            "stage_seconds": stages, "render_fps": n_frames / stages["render"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "commands": [p for p in printed if p.startswith("section ")]}


def video_audio_correlation(frames, audio_feats, device):
    """The video descriptors of `frames` (T, H, W, 3) in [0, 1] on `device`,
    resampled to the audio features' frames, and the whole metric battery:
    (metrics, video feature matrix, seconds)."""
    import torch

    from maua_tpu_torch.audiovisual.selfsupervised.correlation import audio_video_correlation
    from maua_tpu_torch.audiovisual.selfsupervised.video_features import video_feature_matrix

    t0 = time.perf_counter()
    video = video_feature_matrix(torch.from_numpy(frames).to(device), n_frames_out=audio_feats.shape[0])
    metrics = audio_video_correlation(audio_feats.to(device), video)
    return metrics, video, time.perf_counter() - t0


def moves_at_roundoff(name: str, X, Y, value: float, trials: int = 3) -> bool:
    """Whether a metric of the CPU's (X, Y) moves by more than 1e-3 when both
    move by 1e-6 of their peaks (seeded normal noise, a few draws): a value
    f32 roundoff decides, as the subspaces and covariance inverses of
    rank-deficient features are."""
    import torch

    from maua_tpu_torch.audiovisual.selfsupervised.correlation import METRICS

    gen = torch.Generator().manual_seed(0)

    def nudge(Z):
        return Z + 1e-6 * float(Z.abs().max()) * torch.randn(Z.shape, generator=gen)

    return any(abs(float(METRICS[name](nudge(X), nudge(Y))) - value) > 1e-3 for _ in range(trials))


def correlation_pairs():
    """The metric battery's well-conditioned pairs (as the CPU tests make
    them): a correlated pair of unequal widths, an independent one, and
    matched widths (X against X without one principal component, and
    against noise)."""
    import numpy as np

    rs = np.random.RandomState(0)
    X = rs.randn(64, 5).astype(np.float32)
    Y = X @ rs.randn(5, 3).astype(np.float32) + 0.1 * rs.randn(64, 3).astype(np.float32)
    Z = rs.randn(64, 3).astype(np.float32)
    rs = np.random.RandomState(1)
    A = rs.randn(120, 16).astype(np.float32)
    A -= A.mean()
    U, s, V = np.linalg.svd(A, full_matrices=False)
    A1 = (np.delete(U, 2, 1) @ np.diag(np.delete(s, 2)) @ np.delete(V, 2, 0)).astype(np.float32)
    A2 = rs.randn(120, 16).astype(np.float32)
    return {"dependent": (X, Y), "independent": (X, Z), "minus_one_pc": (A, A1), "noise": (A, A2)}


def signed_like_card(name: str, X, Y):
    """r2 or r4 of the CPU's (X, Y) with each of the CPU's left singular
    vectors given the sign of the card's: maua_tpu's r2 and r4 read the
    SVD's column signs, which LAPACK and cuSOLVER choose apart (ROADMAP.md
    C8), so the card's value is held against this one."""
    import torch

    from maua_tpu_torch.audiovisual.selfsupervised import correlation as C

    def factors(M):
        Uc = C._svd(C._center(M.cuda()))[0].cpu()
        U, s, _ = C._svd(C._center(M))
        sign = torch.where((Uc * U).sum(dim=0) < 0, -1.0, 1.0)
        return U * sign, s

    (UX, sX), (UY, sY) = factors(X), factors(Y)
    return C.r1(UX * sX[None], UY * sY[None]) if name == "r2" else C.r1(UX, UY)


def metrics_card_vs_cpu() -> dict:
    """Every metric of the battery on each of correlation_pairs, on the card
    (TF32 off) against the CPU: held within 1e-3 (the CPU tests' bar) on
    the three pairs of full rank; reported on minus_one_pc, which is rank
    deficient by construction, so that the metrics built on a subspace
    (r3's polar factor, CCA's directions in the null space) are not unique
    there. r2 and r4 are held against the CPU's value with the card's
    singular vector signs (signed_like_card). The largest difference by
    metric on each."""
    import torch

    from maua_tpu_torch.audiovisual.selfsupervised import correlation as C

    diffs, failed = {"full_rank": {}, "minus_one_pc": {}}, []
    with tf32_off():
        for label, (X, Y) in correlation_pairs().items():
            held = label != "minus_one_pc"
            for name, fn in C.METRICS.items():
                if X.shape[1] != Y.shape[1] and name in C._MATCHED_DIMS_ONLY:
                    continue
                card = float(fn(torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()))
                host = float(signed_like_card(name, torch.from_numpy(X), torch.from_numpy(Y)) if name in ("r2", "r4")
                             else fn(torch.from_numpy(X), torch.from_numpy(Y)))
                by_metric = diffs["full_rank" if held else label]
                by_metric[name] = max(by_metric.get(name, 0.0), abs(card - host))
                if held and not (math.isfinite(card) and abs(card - host) <= 1e-3):
                    failed.append(f"{name} on the {label} pair: card {card}, CPU {host}")
    if failed:
        raise AssertionError(f"av_correlation card vs CPU: {failed}")
    return diffs


def run_av_correlation(wav: str, tmp: str):
    """The video descriptors of the first AV_FRAMES frames of the ss_e2e clip
    as read back (1024^2) on the card, against the wav's self-supervised
    audio features (hop 1024) over the same time, and every metric of the
    battery: seconds, every metric finite. Then the clip's first AV_REFERENCE_FRAMES frames on the card and
    on the CPU, f32 with TF32 off, metric by metric within 1e-3 (the CPU
    tests' bar) but where the CPU's own value moves by more than that at
    f32 roundoff (moves_at_roundoff; reported): 6 frames resampled to 64
    rows against a few hundred columns leave the metrics that whiten or
    invert a covariance ill-posed. Every metric is then held card against
    CPU on the CPU tests' pairs of full rank (metrics_card_vs_cpu)."""
    import numpy as np
    import torch

    from maua_tpu_torch.audio.io import load_audio
    from maua_tpu_torch.audiovisual.selfsupervised.mir import retrieve_music_information
    from maua_tpu_torch.ops.video import read_video

    clip = os.path.join(tmp, "ss.mp4")
    if not os.path.exists(clip):
        run_ss_e2e(wav, tmp)
    frames, _ = read_video(clip)
    audio, sr, _ = load_audio(wav)
    feats, _, _ = retrieve_music_information(torch.from_numpy(audio).cuda(), sr)
    X = torch.cat(list(feats.values()), dim=1)
    rows = round(X.shape[0] * AV_FRAMES / frames.shape[0])  # the audio frames of the same seconds
    metrics, video, seconds = video_audio_correlation(frames[:AV_FRAMES], X[:rows], "cuda")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"av_correlation: non-finite metrics {metrics}")
    with tf32_off():
        card, _, card_seconds = video_audio_correlation(frames[:AV_REFERENCE_FRAMES], X, "cuda")
    host, host_video, cpu_seconds = video_audio_correlation(frames[:AV_REFERENCE_FRAMES], X.cpu(), "cpu")
    diffs = {k: abs(card[k] - host[k]) for k in host}
    over = {k: d for k, d in diffs.items() if d > 1e-3}
    at_roundoff = {k: moves_at_roundoff(k, X.cpu(), host_video, host[k]) for k in over}
    if set(card) != set(host) or not all(at_roundoff.values()):
        raise AssertionError(f"av_correlation card vs CPU: {diffs}, moving at f32 roundoff: {at_roundoff}")
    pairs = metrics_card_vs_cpu()
    return {"frames": [AV_FRAMES, *frames.shape[1:]], "audio_features": [rows, X.shape[1]],
            "video_features": int(video.shape[1]),
            "seconds": seconds, "metrics": metrics, "pairs_card_vs_cpu_by_metric": pairs,
            "card_vs_cpu_by_metric": diffs,
            "card_vs_cpu_max_abs_of_the_rest": max(d for k, d in diffs.items() if k not in over),
            "over_1e-3_and_moving_at_roundoff": sorted(over), "reference_frames": AV_REFERENCE_FRAMES,
            "reference_card_seconds": card_seconds, "reference_cpu_seconds": cpu_seconds}

LANGEVIN_PROMPT = "a red fox"
LANGEVIN_SEEDS = "0-2"  # two images at the command's defaults (50 Langevin steps)
# dE/dz at 1024^2 through the kernel route against the plain version, of its largest magnitude, with cuDNN's
# deterministic algorithms: the two forwards round apart (the kernel's fused multiply-adds) and 18 f32 conv
# layers, the resize and CLIP's 12 blocks carry that to the gradient, as far as one ulp on every epilogue output
# does (run_gan_langevin measures both); a dropped or detached epilogue gradient moves it by over 0.1. Each
# case's own gradients are held to GRAD_BAR (check_epilogue_gradients)
LANGEVIN_ROUTE_BAR = 1e-3
ZOO_ITERS = 5  # iterations of each style_zoo transfer (cut from the CLI's 512 to 10, then 5)
ZOO_PSNR_BAR = 40.0  # the stylegan loss gradient card vs CPU at 128^2, TF32 off: dB
VIT_ITERS = 10  # Adam iterations of the video_vit phase (cut from 100 to 20, then 10)
NCA_STEPS, NCA_FRAMES = 20, 120  # nca run: training steps (cut from 2000), rendered frames (cut from 600)
NCA_PARITY_STEPS = 2  # training steps at 128^2 held card vs CPU on the same draws (cut from 6 for time)
OPT_STEPS = 5  # steps of each registry name in the optimizers phase (cut from 10 for time)
OPT_TOL = 1e-5  # each registry name card vs CPU, TF32 off: of each parameter's largest magnitude
# shampoo and lookahead-shampoo: on the CPU alone, gradients put one ulp off move their parameters by 3e-5 to
# 3.5e-4 of their largest magnitude after OPT_STEPS steps (every other name: under 2e-7), so no bar under that
# tells the two devices' last-bit differences in the statistics' products and eigh from a fault; card vs CPU
# they read 2.7e-5 to 2.33e-4 over the nine problems (H100 80GB HBM3, 700.00 W); a wrong power or a dropped
# preconditioner moves them by O(1)
OPT_TOL_SHAMPOO = 1e-3
SHAMPOO_PROBLEMS = 8  # further draws of the optimizers problem for the two shampoo names


@contextlib.contextmanager
def autograd_epilogue_cases():
    """Counts the epilogue's launches on the card under autograd (`ModconvEpilogue`'s forward), by case:
    (z's shape, its dtype, the noise's shape or None, whether a next style scale is applied, alpha, gain,
    clamp)."""
    import collections

    from maua_tpu_torch.kernels import epilogue as E

    cases = collections.Counter()
    real = E.ModconvEpilogue.forward

    def recording(z, post, noise, bias, pre_next, alpha, gain, clamp):
        if z.is_cuda:
            cases[(tuple(z.shape), str(z.dtype).removeprefix("torch."), None if noise is None else tuple(noise.shape),
                   pre_next is not None, alpha, gain, clamp)] += 1
        return real(z, post, noise, bias, pre_next, alpha, gain, clamp)

    E.ModconvEpilogue.forward = staticmethod(recording)
    try:
        yield cases
    finally:
        E.ModconvEpilogue.forward = staticmethod(real)


def check_epilogue_gradients(cases, what: str):
    """At every case met under autograd (a Counter of autograd_epilogue_cases' keys): random card tensors
    of that case's shapes, the five gradients (dz, dpost, dnoise, dbias, dpre_next) through the kernel route
    (`ModconvEpilogue`: the kernel forward, the recomputed f32 backward) against autograd of the plain
    version on the card, each within GRAD_BAR of its largest magnitude, plus one bf16 ulp (2^-8) of it in
    bf16. Then the backward's time (`bwd_ms`, cuda_time_ms), the plain version's autograd backward
    (`plain_bwd_ms`) and the backward's bound: reading z and g and writing dz (and the noise's gradient)
    over 3.35 TB/s, against some 20 f32 operations an element over 67 TFLOP/s. The comparison launches do
    not count."""
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for (shape, dtype, noise_shape, pre, alpha, gain, clamp), n in sorted(cases.items(), key=lambda c: -c[1]):
        dt = getattr(torch, dtype)
        b, c = shape[:2]

        def rnd(*s):
            return torch.randn(*s, generator=gen, device="cuda")

        leaves = {"z": (rnd(*shape) * 4).to(dt), "post": rnd(b, c).abs() + 0.1,
                  "noise": None if noise_shape is None else rnd(*noise_shape), "bias": rnd(c) * 0.1,
                  "pre_next": rnd(b, c).abs() + 0.5 if pre else None}
        g = rnd(*shape).to(dt)
        outs, grads = {}, {}
        for route, fn in (("kernel", E.modconv_epilogue), ("plain", E.modconv_epilogue_plain)):
            ts = {k: None if v is None else v.clone().requires_grad_(True) for k, v in leaves.items()}
            y = fn(ts["z"], ts["post"], ts["noise"], ts["bias"], alpha, gain, clamp, ts["pre_next"])
            names = [k for k, t in ts.items() if t is not None]
            got = torch.autograd.grad(y, [ts[k] for k in names], g, retain_graph=True)
            outs[route] = (y, [ts[k] for k in names])
            grads[route] = dict(zip(names, got))
        if type(outs["kernel"][0].grad_fn).__name__ != "ModconvEpilogueBackward":
            raise AssertionError(f"{what}: the epilogue's kernel route is not under its autograd Function")
        errs = {}
        for k, ref in grads["plain"].items():
            scale = float(ref.float().abs().max())
            errs[f"d{k}"] = float((grads["kernel"][k].float() - ref.float()).abs().max()) / max(scale, 1e-30)
        bar = GRAD_BAR + (2.0**-8 if dt == torch.bfloat16 else 0.0)
        row = {"shape": list(shape), "dtype": dtype, "noise": noise_shape and list(noise_shape), "pre_next": pre,
               "clamp": clamp, "launches_under_autograd": n, "grad_rel_err": errs}
        if max(errs.values()) > bar:
            raise AssertionError(f"{what}: the epilogue's gradient disagrees with the plain version's at {row}")
        numel, item = math.prod(shape), leaves["z"].element_size()
        nbytes = 3 * numel * item + (4 * math.prod(noise_shape) if noise_shape else 0)
        row.update(
            bwd_ms=cuda_time_ms(lambda: torch.autograd.grad(outs["kernel"][0], outs["kernel"][1], g,
                                                            retain_graph=True), iters=5),
            plain_bwd_ms=cuda_time_ms(lambda: torch.autograd.grad(outs["plain"][0], outs["plain"][1], g,
                                                                  retain_graph=True), iters=5),
            bwd_bound_ms=max(nbytes / HBM_BYTES_PER_S, 20 * numel / F32_FLOPS) * 1e3)
        rows.append(row)
        del leaves, g, outs, grads
        torch.cuda.empty_cache()
    E.reset_launches()
    return rows


def run_epilogue_grad():
    """ModconvEpilogue's five gradients at every epilogue shape of a 1024^2 StyleGAN2 frame batch of 8 (the
    plain route's b4..b1024 with the example patch's noise, and the s2d route's cells with pre_next), in f32
    and in bf16, each against the plain version's autograd on the card (check_epilogue_gradients); the
    backward's ms per frame batch (each layer's case times its convs) beside its bound and the plain
    version's. Then the second-order gradients at the plain route's layer shapes in both dtypes
    (check_epilogue_second_order), the detached backward's reading beside them."""
    import collections

    import torch

    cfg, cases = epilogue_cases()
    counted, reps = collections.Counter(), {}
    for label, b, c, h, w, _, nb, g, pre, clamp in cases:
        plain_layer = label.startswith("b") and label[1:].isdigit()
        if not (plain_layer or label.startswith("s2d-b")) or label.endswith("frame-noise"):
            continue
        for dtype in ("float32", "bfloat16"):
            key = ((b, c, h, w), dtype, (nb, g, h, w), pre, 0.2, math.sqrt(2.0), clamp)
            counted[key] += 1
            reps[key] = cfg.block_num_conv(int(label[1:])) if plain_layer else 1
    rows = check_epilogue_gradients(counted, "epilogue_grad")
    out = {"cases": len(rows), "grad_max_rel_err": {d: max(max(r["grad_rel_err"].values()) for r in rows
                                                           if r["dtype"] == d) for d in ("float32", "bfloat16")}}
    second = check_epilogue_second_order([k for k in counted if k[2][1] == 1 and not k[3]], "epilogue_grad")
    out.update(second_order_cases=len(second), second_order_max_rel_err={
        d: max(max(r["second_order_rel_err"].values()) for r in second if r["dtype"] == d)
        for d in ("float32", "bfloat16")}, detached_min_rel_err=min(max(r["detached_rel_err"].values())
                                                                     for r in second))
    for r in second:
        print(json.dumps({"epilogue_second_order": r}), flush=True)
    for dtype in ("float32", "bfloat16"):
        for route, groups in (("plain_route", 1), ("s2d_cells", 4)):
            sel = [r for r in rows if r["dtype"] == dtype and r["noise"][1] == groups]
            keys = [(tuple(r["shape"]), dtype, tuple(r["noise"]), r["pre_next"], 0.2, math.sqrt(2.0), r["clamp"])
                    for r in sel]
            out[f"{route}_{dtype}"] = {k: sum(reps[key] * r[k] for key, r in zip(keys, sel))
                                       for k in ("bwd_ms", "plain_bwd_ms", "bwd_bound_ms")}
    for r in rows:
        print(json.dumps({"epilogue_grad": r}), flush=True)
    torch.cuda.empty_cache()
    return out


def clip_energy_grad(device: str, size: int, g_params, clip_perceptor, z):
    """dE/dz of CLIP-guided Langevin's energy (gan/sampling.clip_energy) through an f32 StyleGAN2 at
    size^2 with the given parameters and CLIP perceptor, on `device`."""
    import torch

    from maua_tpu_torch.gan import sampling as S
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.utility import to_device

    gan = S2.Generator(S2.SG2Config(img_resolution=size, num_fp16_res=0), params=to_device(g_params, device))
    energy = S.clip_energy(gan, LANGEVIN_PROMPT, perceptor=clip_perceptor)
    zz = z.to(device).requires_grad_(True)
    (grad,) = torch.autograd.grad(energy(zz).sum(), zz)
    return grad.cpu().numpy()


def run_gan_langevin(tmp: str):
    """`python -m maua_tpu_torch gan generate --sampling langevin --langevin_critic "a red fox" --seeds 0-2`
    at 1024^2 (seed-0 StyleGAN2 and CLIP ViT-B/32, the command's 50 steps): the PNGs written and distinct,
    the epilogue's launches and those under autograd (17 a Langevin step), each such case's five gradients
    against the plain version's (check_epilogue_gradients). Then dE/dz of the energy at 1024^2 (f32, TF32
    off, cuDNN's deterministic algorithms) through the kernel route against the plain version on the card,
    within LANGEVIN_ROUTE_BAR of its largest magnitude; beside it, against the same plain version, the plain
    version run again (also under the default flags), the Function's backward on the plain forward, every
    epilogue output one ulp off, and two wrong gradients that must land beyond the bar (a launch with no
    grad_fn, dpost dropped). Then dE/dz at 128^2 card vs CPU, TF32 off (PSNR, peak the CPU gradient's
    largest magnitude)."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.perceptors.clip import CLIPPerceptor

    out_dir = os.path.join(tmp, "gan_langevin")
    E.reset_launches()
    t0 = time.perf_counter()
    with autograd_epilogue_cases() as cases:
        command.main(["gan", "generate", "--sampling", "langevin", "--langevin_critic", LANGEVIN_PROMPT, "--seeds",
                      LANGEVIN_SEEDS, "--out_dir", out_dir])
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, E.launches
    files = sorted(os.listdir(out_dir))
    imgs = [np.asarray(Image.open(os.path.join(out_dir, f))) for f in files]
    if len(files) != 2 or len({im.tobytes() for im in imgs}) != 2 or any(im.shape != (1024, 1024, 3) for im in imgs):
        raise AssertionError(f"gan langevin: {files}, {[im.shape for im in imgs]}")
    under = sum(cases.values())
    if under < 17 * 50 or launches < under:
        raise AssertionError(f"gan langevin: {launches} launches, {under} under autograd")
    out = {"command_seconds": seconds, "pngs": len(files), "launches": launches, "launches_under_autograd": under,
           "gradient_cases": check_epilogue_gradients(cases, "gan_langevin")}
    # dE/dz at 1024^2, f32: the kernel route against the plain version, both on the card
    cpu_clip = CLIPPerceptor(device="cpu")
    card_clip = CLIPPerceptor(vision_params=cpu_clip.vision_params, text_params=cpu_clip.text_params,
                              text_proj=cpu_clip.text_proj, device="cuda")
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(1))
    params = S2.init_params(S2.SG2Config(num_fp16_res=0), torch.Generator(device="cuda").manual_seed(0))
    ulp_gen = torch.Generator(device="cuda").manual_seed(3)

    def plain_launch(z, post, noise, bias, alpha, gain, clamp, pre_next):
        return E.modconv_epilogue_plain(z, post, noise, bias, alpha, gain, clamp, pre_next)

    def one_ulp_off(*a, **k):  # the plain version's output moved one ulp, each element a random way
        y = E.modconv_epilogue_plain(*a, **k)
        yd, up = y.detach(), torch.rand(y.shape, generator=ulp_gen, device=y.device) < 0.5
        return y + (torch.nextafter(yd, torch.where(up, math.inf, -math.inf).to(yd)) - yd)

    def detached_launch(z, post, noise, bias, alpha=0.2, gain=math.sqrt(2.0), clamp=256.0, pre_next=None):
        return E._launch(z, post, noise, bias, alpha, gain, clamp, pre_next)  # a launch with no grad_fn

    real_backward = E.ModconvEpilogue.backward

    def without_dpost(ctx, g):
        grads = list(real_backward(ctx, g))
        grads[1] = None if grads[1] is None else torch.zeros_like(grads[1])
        return tuple(grads)

    spread = {}
    with tf32_off():  # the flags the command runs under: cuDNN free to pick algorithms that sum with atomics
        for k in ("plain", "plain_again"):
            with swapped(S2, "modconv_epilogue", E.modconv_epilogue_plain):
                spread[k] = clip_energy_grad("cuda", 1024, params, card_clip, z)
    det = torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    variants = {}
    with tf32_off(), det:
        kernel_grad = clip_energy_grad("cuda", 1024, params, card_clip, z)
        with swapped(S2, "modconv_epilogue", E.modconv_epilogue_plain):
            plain_grad = clip_energy_grad("cuda", 1024, params, card_clip, z)
            variants["plain_again"] = clip_energy_grad("cuda", 1024, params, card_clip, z)
        with swapped(E, "_launch", plain_launch):  # the Function's backward alone
            variants["function_on_the_plain_forward"] = clip_energy_grad("cuda", 1024, params, card_clip, z)
        with swapped(S2, "modconv_epilogue", one_ulp_off):  # forward rounding alone
            variants["plain_one_ulp_off"] = clip_energy_grad("cuda", 1024, params, card_clip, z)
        with swapped(S2, "modconv_epilogue", detached_launch):  # what the check must catch
            variants["detached_launch"] = clip_energy_grad("cuda", 1024, params, card_clip, z)
        with swapped(E.ModconvEpilogue, "backward", staticmethod(without_dpost)):
            variants["backward_without_dpost"] = clip_energy_grad("cuda", 1024, params, card_clip, z)
    scale = np.abs(plain_grad).max()
    rel = float(np.abs(kernel_grad - plain_grad).max() / scale)
    isolated = {k: float(np.abs(v - plain_grad).max() / scale) for k, v in variants.items()}
    isolated["plain_again_default_flags"] = float(np.abs(spread["plain_again"] - spread["plain"]).max() / scale)
    if not rel <= LANGEVIN_ROUTE_BAR:
        raise AssertionError(f"gan langevin: dE/dz through the kernel {rel} from the plain version's ({isolated})")
    if not (isolated["function_on_the_plain_forward"] <= LANGEVIN_ROUTE_BAR
            and min(isolated["detached_launch"], isolated["backward_without_dpost"]) > LANGEVIN_ROUTE_BAR):
        raise AssertionError(f"gan langevin: dE/dz isolation {isolated} (bar {LANGEVIN_ROUTE_BAR})")
    del params, variants
    torch.cuda.empty_cache()
    small = S2.init_params(S2.SG2Config(img_resolution=128, num_fp16_res=0), torch.Generator().manual_seed(0))
    with tf32_off():
        card, cpu = clip_energy_grad("cuda", 128, small, card_clip, z), clip_energy_grad("cpu", 128, small, cpu_clip, z)
    psnr = psnr_db(card, cpu, float(np.abs(cpu).max()))
    if not psnr >= ZOO_PSNR_BAR:
        raise AssertionError(f"gan langevin: dE/dz card vs CPU {psnr} dB")
    E.reset_launches()
    return {**out, "grad_kernel_vs_plain_rel_err": rel, "grad_vs_plain_rel_err_of": isolated,
            "grad_kernel_vs_plain_psnr_db": psnr_db(kernel_grad, plain_grad, float(np.abs(plain_grad).max())),
            "grad_card_vs_cpu_psnr_db": psnr}


def stylegan_loss_and_grad(content: str, style: str, size: int, device: str, g_params, vgg, z):
    """One evaluation of style/image.transfer's loss through the stylegan parameterization (an f32
    StyleGAN2 at size^2 with the given parameters, w+ from z) and kbc-vgg19 (the given parameters) at its
    default weights, and the gradient with respect to w+, on `device`."""
    import torch

    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.loss import gram_matrix, scaled_mse_loss, tv_loss
    from maua_tpu_torch.ops.image import resample
    from maua_tpu_torch.ops.io import load_images
    from maua_tpu_torch.parameterizations import load_parameterization
    from maua_tpu_torch.style.image import build_perceptor, style_targets, to_image
    from maua_tpu_torch.utility import to_device

    c, (s,) = load_images(content, [style])
    c, s = resample(to_image(c, device), size), resample(to_image(s, device), size)
    percept = build_perceptor("kbc-vgg19", {"params": vgg}, device)
    gan = S2.Generator(S2.SG2Config(img_resolution=size, num_fp16_res=0), params=to_device(g_params, device))
    pastiche = load_parameterization("stylegan")(size, size, generator=gan, z=z.to(device), device=device)
    with torch.no_grad():
        feats = percept.get_features(c)
        content_targets = [feats[i] for i in percept.content_layers]
    targets = style_targets(percept, [s])
    img = pastiche.decode()
    feats = percept.get_features(img)
    loss = 100.0 * tv_loss(img)
    for i, t in zip(percept.content_layers, content_targets):
        loss = loss + scaled_mse_loss(feats[i], t)
    for i, t in zip(percept.style_layers, targets):
        loss = loss + 50.0 * scaled_mse_loss(gram_matrix(feats[i]), t)
    loss.backward()
    return float(loss.detach()), pastiche.tensor.grad.cpu().numpy()


def run_style_zoo(tmp: str):
    """style/image.transfer at 512^2 (the CLI's size), ZOO_ITERS iterations each: the stylegan
    parameterization (a full-width seed-0 StyleGAN2 at 512^2, f32, init_type "random") with adam, whose
    every decode launches the epilogue 15 times, under autograd in the loop (each such case's gradients
    checked); pgg-vgg19 with lbfgs and nin with avg pooling (the caffe zoo, seed-0 draws); nima_score of the
    vgg19 result; ranger (a Lookahead over RAdam, which maua_tpu's route cannot run). Seconds per iteration
    (the loop's), launches, peak memory. Card vs CPU at 128^2, TF32 off: the stylegan loss and its gradient
    with respect to w+ (PSNR, peak the CPU gradient's largest magnitude) at least ZOO_PSNR_BAR."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.perceptors import vgg as VGG
    from maua_tpu_torch.perceptors.nima import nima_score
    from maua_tpu_torch.style.image import transfer

    content, style = os.path.join(tmp, "zoo_content.png"), os.path.join(tmp, "zoo_style.png")
    write_frame(content, 512, 6)
    write_style_image(style, 512, seed=7)
    runs = (("stylegan_adam", dict(parameterization="stylegan", init_type="random", optimizer="adam", lr=0.05)),
            ("pgg_vgg19_lbfgs", dict(perceptor="pgg-vgg19")),
            ("nin_avg_lbfgs", dict(perceptor="nin", perceptor_kwargs={"pooling": "avg"})),
            ("rgb_ranger", dict(optimizer="ranger", lr=0.05)))
    out, imgs = {}, {}
    for name, kw in runs:
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        E.reset_launches()
        with autograd_epilogue_cases() as cases:
            t0 = time.perf_counter()
            img = transfer(content, [style], n_iters=ZOO_ITERS, device="cuda", stats=stats, verbose=False, **kw)
            torch.cuda.synchronize()
        check_image(img, (1, 512, 512, 3), f"style_zoo {name}")
        imgs[name] = img
        out[name] = {"seconds": time.perf_counter() - t0, "seconds_per_iteration": stats["loop_seconds"] / ZOO_ITERS,
                     "evaluations_per_iteration": stats["evaluations"] / ZOO_ITERS, "launches": E.launches,
                     "launches_under_autograd": sum(cases.values()),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name == "stylegan_adam":
            if E.launches != 15 * (ZOO_ITERS + 1) or sum(cases.values()) != 15 * ZOO_ITERS:
                raise AssertionError(f"style_zoo stylegan: {E.launches} launches, {sum(cases.values())} under "
                                     f"autograd (want {15 * (ZOO_ITERS + 1)}, {15 * ZOO_ITERS})")
            out[name]["gradient_cases"] = check_epilogue_gradients(cases, "style_zoo")
        torch.cuda.empty_cache()
    score, std = (float(v) for v in nima_score((imgs["pgg_vgg19_lbfgs"] + 1) / 2, device="cuda"))
    if not (0 <= score <= 9 and np.isfinite(std)):
        raise AssertionError(f"style_zoo nima: {score}, {std}")
    out["nima"] = {"score": score, "std": std}
    vgg = VGG.init_params(torch.Generator().manual_seed(0))
    g_params = S2.init_params(S2.SG2Config(img_resolution=128, num_fp16_res=0), torch.Generator().manual_seed(0))
    z = torch.randn(1, 512, generator=torch.Generator().manual_seed(2))
    with tf32_off():
        (loss_card, grad_card), (loss_cpu, grad_cpu) = (stylegan_loss_and_grad(content, style, 128, dev, g_params,
                                                                               vgg, z) for dev in ("cuda", "cpu"))
    psnr = psnr_db(grad_card, grad_cpu, float(np.abs(grad_cpu).max()))
    if not psnr >= ZOO_PSNR_BAR:
        raise AssertionError(f"style_zoo stylegan card vs CPU: gradient {psnr} dB")
    out["card_vs_cpu"] = {"loss_card": loss_card, "loss_cpu": loss_cpu, "grad_psnr_db": psnr}
    E.reset_launches()
    return out


def run_video_vit():
    """style/video_vit.video_style_transfer at VideoViTConfig(image_size=256) (width 128, 4 layers, 4 heads,
    patch 8, tubelet 2; seed-0 weights) over an 8-frame 256^2 pan (3 px a frame) and a noise style clip,
    VIT_ITERS Adam iterations: seconds per iteration (the loop's), peak memory, the clip finite and moved."""
    import numpy as np
    import torch

    from maua_tpu_torch.style.video_vit import VideoViTConfig, video_style_transfer

    rs = np.random.RandomState(8)
    y, x = np.mgrid[0:256, 0:280] / 256
    field = np.stack([0.5 + 0.4 * np.sin(6 * x), y, 1 - x * y / 1.2], -1) * 0.8 + rs.rand(256, 280, 3) * 0.2
    content = np.stack([field[:, 3 * t:3 * t + 256] for t in range(8)]).astype(np.float32) * 2 - 1
    style = rs.rand(8, 256, 256, 3).astype(np.float32) * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    video = video_style_transfer(content, style, VideoViTConfig(image_size=256), n_iters=VIT_ITERS, device="cuda",
                                 verbose=False, stats=stats)
    seconds = time.perf_counter() - t0
    if video.shape != content.shape or not np.isfinite(video).all() or np.abs(video - content).max() < 1e-3:
        raise AssertionError(f"video_vit: {video.shape}, moved {np.abs(video - content).max()}")
    return {"seconds": seconds, "seconds_per_iteration": stats["loop_seconds"] / VIT_ITERS, "tokens": 4 * 32 * 32,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def run_nca(tmp: str):
    """`python -m maua_tpu_torch nca run --style s.png` (the command's main, in this process): training at
    128^2 (batch 4, rollouts of 32-63 steps, pool 256) for NCA_STEPS steps, then NCA_FRAMES frames rendered
    at 256^2; the params file written, the video read back; seconds per training step, each step's loss,
    its states' largest magnitude and the share of their rgb clipped, render fps. maua_tpu's recipe has no
    overflow loss and its states grow without bound (tools/nca_divergence.py: on its own draws they reach
    1e25 by step 18); a loss may go non-finite only at a step whose states did, and while the states stay
    finite the trained parameters and every rendered frame must be finite too. Then NCA_PARITY_STEPS
    training steps at 128^2 on the card and on the CPU from the same draws, TF32 off: every loss finite on
    both, the parameters' PSNR (peak: the CPU's largest magnitude) at least ZOO_PSNR_BAR. The render fps
    reported is NCA_FRAMES at 256^2 from the card's parity params, every frame finite."""
    import numpy as np
    import torch

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.nca import nca as N
    from maua_tpu_torch.ops import video as V
    from maua_tpu_torch.ops.io import load_image
    from maua_tpu_torch.ops.video import read_video
    from maua_tpu_torch.perceptors.vgg import VGGPerceptor
    from maua_tpu_torch.perceptors.vgg import init_params as vgg_init

    style = os.path.join(tmp, "nca_style.png")
    write_style_image(style, 128, seed=9)
    out_dir = os.path.join(tmp, "nca")
    timed, stats, real = {}, {}, {"train_nca": N.train_nca, "generate_video": N.generate_video}
    trained, finite_frames = {}, []

    def timer(name):
        def call(*a, **k):
            t0 = time.perf_counter()
            r = real[name](*a, **({"stats": stats} if name == "train_nca" else {}), **k)
            timed[name] = time.perf_counter() - t0
            if name == "train_nca":
                trained.update(r)
            return r
        return call

    class Writer(V.VideoWriter):  # notes whether each frame handed to the writer is finite
        def write(self, frame):
            finite_frames.append(bool(np.isfinite(np.asarray(frame)).all()))
            return super().write(frame)

    with contextlib.ExitStack() as stack:
        for name in real:
            stack.enter_context(swapped(N, name, timer(name)))
        stack.enter_context(swapped(V, "VideoWriter", Writer))
        command.main(["nca", "run", "--style", style, "--n_steps", str(NCA_STEPS), "--num_frames", str(NCA_FRAMES),
                      "--out_dir", out_dir])
    frames, fps = read_video(os.path.join(out_dir, "nca_style_nca.mp4"))
    if frames.shape != (NCA_FRAMES, 256, 256, 3) or not os.path.exists(os.path.join(out_dir, "nca_style_nca.pkl")):
        raise AssertionError(f"nca: video {frames.shape}")
    losses, peaks = stats["losses"], stats["state_peaks"]
    if len(losses) != NCA_STEPS or len(finite_frames) != NCA_FRAMES:
        raise AssertionError(f"nca: {len(losses)} training steps, {len(finite_frames)} frames written")
    nan_from_finite = [i for i, (v, p) in enumerate(zip(losses, peaks)) if not math.isfinite(v) and math.isfinite(p)]
    overflow = next((i for i, p in enumerate(peaks) if not math.isfinite(p)), None)
    params_finite = all(bool(torch.isfinite(v).all()) for v in trained.values())
    if nan_from_finite or (overflow is None and not (params_finite and all(finite_frames))):
        raise AssertionError(f"nca: non-finite losses at finite states {nan_from_finite}; overflow at {overflow}, "
                             f"params finite {params_finite}, frames finite {sum(finite_frames)}/{NCA_FRAMES}")
    # card vs CPU at 128^2: the same VGG16, initial params, indices, rollout lengths and masks on both
    gen = torch.Generator().manual_seed(5)
    style_img = torch.from_numpy(load_image(style) * 2 - 1)
    vgg = vgg_init(torch.Generator().manual_seed(0), "vgg16")
    init = N.init_params(torch.Generator().manual_seed(0))
    draws = []
    for _ in range(NCA_PARITY_STEPS):
        n = int(torch.randint(32, 64, (), generator=gen))
        draws.append((torch.randperm(256, generator=gen)[:4], n, torch.rand(n, 4, 128, 128, 1, generator=gen)))
    parity, runs = {}, {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            t0, st = time.perf_counter(), {}
            percept = VGGPerceptor(arch="vgg16", params=vgg, device=dev)
            p = N.train_nca(style_img, n_steps=NCA_PARITY_STEPS, params=init, perceptor=percept, stats=st,
                            draws=lambda i: (draws[i][0], draws[i][1], draws[i][2].to(dev)), device=dev,
                            verbose=False)
            parity[dev] = np.concatenate([v.cpu().numpy().ravel() for v in p.values()])
            if dev == "cuda":
                trained_here = p
            runs[dev] = {"losses": st["losses"], "state_peaks": st["state_peaks"], "clipped": st["clipped"],
                         "seconds": time.perf_counter() - t0}
    psnr = psnr_db(parity["cuda"], parity["cpu"], float(np.abs(parity["cpu"]).max()))
    finite = all(math.isfinite(v) for r in runs.values() for v in r["losses"])
    if not (psnr >= ZOO_PSNR_BAR and finite):
        raise AssertionError(f"nca card vs CPU: {psnr} dB, losses {runs}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"]["losses"], runs["cpu"]["losses"]))
    # the render timed again from the card's finite parity params (the command's may have overflowed)
    del finite_frames[:]
    with swapped(V, "VideoWriter", Writer):
        t0 = time.perf_counter()
        N.generate_video(trained_here, os.path.join(out_dir, "finite.mp4"), num_frames=NCA_FRAMES, device="cuda")
        render_seconds = time.perf_counter() - t0
    if sum(finite_frames) != NCA_FRAMES:
        raise AssertionError(f"nca: {sum(finite_frames)} of {NCA_FRAMES} frames finite from finite params")
    return {"train_seconds": timed["train_nca"], "seconds_per_step": timed["train_nca"] / NCA_STEPS,
            "losses": losses, "state_peaks": peaks, "clipped": stats["clipped"], "first_overflow_step": overflow,
            "params_finite": params_finite, "render_seconds": render_seconds,
            "render_fps": NCA_FRAMES / render_seconds, "command_render_seconds": timed["generate_video"],
            "frames_read_back": int(frames.shape[0]), "video_fps": fps, "card_vs_cpu_params_psnr_db": psnr,
            "card_vs_cpu_loss_max_rel_diff": loss_rel, "card_vs_cpu_runs": runs,
            "card_seconds_per_finite_step": runs["cuda"]["seconds"] / NCA_PARITY_STEPS}


def run_optimizers():
    """Every registry name (104) for OPT_STEPS steps on an (8, 6) and a (6,) parameter under an
    elementwise nonquadratic loss, on the card and on the CPU (TF32 off; noisysgd with the same normals handed to
    both), each parameter within OPT_TOL of its largest magnitude; the L-BFGS names step with a closure. Beside
    each name's error, its sensitivity: how far a second CPU run moves when every gradient is put one ulp off,
    each element a random way. The two shampoo names are held to OPT_TOL_SHAMPOO, on this problem and on
    SHAMPOO_PROBLEMS further draws of it."""
    import numpy as np
    import torch

    from maua_tpu_torch import optimizers as O

    def problem(seed):
        rs = np.random.RandomState(seed)
        w0, b0 = rs.randn(8, 6).astype(np.float32), rs.randn(6).astype(np.float32)
        a, t = (rs.rand(8, 6) + 0.5).astype(np.float32), rs.randn(8, 6).astype(np.float32)
        noise = [[rs.randn(8, 6).astype(np.float32), rs.randn(6).astype(np.float32)] for _ in range(OPT_STEPS)]
        return w0, b0, a, t, noise

    def run(name, device, prob, ulp=None):
        w0, b0, a, t, noise = prob
        w = torch.tensor(w0, device=device, requires_grad=True)
        b = torch.tensor(b0, device=device, requires_grad=True)
        at, tt = torch.from_numpy(a).to(device), torch.from_numpy(t).to(device)
        kw = {"draws": iter(noise)} if name.endswith("noisysgd") else None
        opt = O.load_optimizer(name, 0.01, kw)[0]([w, b])

        def closure():
            opt.zero_grad()
            # every term elementwise, so both devices compute the same gradient bit for bit and the check reads
            # the optimizers' own arithmetic (a reduction in the loss, e.g. w @ b, differs in its last bits between
            # the devices, and pid's derivative term magnifies that tenfold)
            loss = (at * (w - tt) ** 2).sum() + (w**4).sum() * 0.05 + ((b - 0.5) ** 4).sum() * 0.1
            loss.backward()
            if ulp is not None:
                for p in (w, b):
                    way = torch.from_numpy(np.where(ulp.rand(*p.shape) < 0.5, np.inf, -np.inf).astype(np.float32))
                    p.grad = torch.nextafter(p.grad, way)
            return loss

        for _ in range(OPT_STEPS):
            if getattr(opt, "closure_step", False):
                opt.step(closure)
            else:
                closure()
                opt.step()
        return [w.detach().cpu().numpy(), b.detach().cpu().numpy()]

    def rel(xs, ys):
        return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)) for x, y in zip(xs, ys))

    prob = problem(10)
    errs, sens, still, t0 = {}, {}, [], time.perf_counter()
    with tf32_off():
        for name in O.optimizer_choices:
            card, cpu = run(name, "cuda", prob), run(name, "cpu", prob)
            errs[name] = rel(card, cpu)
            sens[name] = rel(run(name, "cpu", prob, np.random.RandomState(1)), cpu)
            if all(np.abs(h - p).max() < 1e-6 for h, p in zip(cpu, prob[:2])):
                still.append(name)
        shampoo = [n for n in errs if n.endswith("shampoo")]
        more = {}
        for seed in range(11, 11 + SHAMPOO_PROBLEMS):
            p = problem(seed)
            for name in shampoo:
                cpu = run(name, "cpu", p)
                more[f"{name}/{seed}"] = (rel(run(name, "cuda", p), cpu),
                                          rel(run(name, "cpu", p, np.random.RandomState(1)), cpu))
    more.update({n: (errs[n], sens[n]) for n in shampoo})
    bad = {n: e for n, e in errs.items() if n not in shampoo and not e <= OPT_TOL}
    bad.update({n: e for n, (e, _) in more.items() if not e <= OPT_TOL_SHAMPOO})
    if bad or still:
        raise AssertionError(f"optimizers: card vs CPU beyond the bar {bad}; parameters unmoved {still}")
    rest = {n: e for n, e in errs.items() if n not in shampoo}
    return {"names": len(errs), "max_rel_err": max(rest.values()), "worst": max(rest, key=rest.get),
            "max_one_ulp_sensitivity": max(v for n, v in sens.items() if n not in shampoo),
            "shampoo_rel_err_and_one_ulp_sensitivity": more,
            "seconds": time.perf_counter() - t0}


def detached_epilogue_backward(ctx, g):
    """ModconvEpilogue's backward as it stood before its second-order repair: the saved inputs detached and no
    graph taken, so a double backward loses every term through the epilogue. Only the known-wrong readings
    (epilogue_grad, gan_train_reference) swap it in."""
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    with torch.enable_grad():
        z, post, noise, bias, pre_next = inputs
        y = E.modconv_epilogue_plain(z, post, noise, bias, ctx.alpha, ctx.gain, ctx.clamp, pre_next)
        grads = iter(torch.autograd.grad(y, wanted, g))
    return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs), None, None, None)


def epilogue_rounded_once(z, post, noise, bias, alpha=0.2, gain=math.sqrt(2.0), clamp=256.0, pre_next=None):
    """The epilogue's plain version with its output put at the f64 evaluation rounded once to z's dtype (what a
    kernel that rounds exactly would return); its gradient stays the plain version's."""
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    y = E.modconv_epilogue_plain(z, post, noise, bias, alpha, gain, clamp, pre_next)
    b, c, h, w = z.shape
    x = z.detach().double() * post.detach().double()[:, :, None, None]
    if noise is not None:
        groups = noise.shape[1]
        x = (x.view(b, groups, c // groups, h, w) + noise.detach().double()[:, :, None]).view(b, c, h, w)
    x = x + bias.detach().double()[None, :, None, None]
    x = torch.where(x >= 0, x, x * alpha) * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    if pre_next is not None:
        x = x * pre_next.detach().double()[:, :, None, None]
    return y + (x.to(y.dtype) - y.detach())


def check_epilogue_second_order(cases, what: str):
    """At each case (the keys of autograd_epilogue_cases): random card tensors of that case's shapes, and
    s = sum_I <dI, v_I> over the first-order gradients of <y, g> (create_graph) with random directions v_I;
    the gradient of s with respect to z, post, noise, bias, pre_next and g (every second derivative of the
    epilogue) through the kernel route (`ModconvEpilogue`: the kernel forward, the differentiable recomputed
    backward) against autograd of the plain version on the card, each within GRAD_BAR of its largest
    magnitude (plus one bf16 ulp in bf16). Beside it the same through the detached backward
    (detached_epilogue_backward, the route before the repair), whose reading the bar must reject."""
    import torch

    from maua_tpu_torch.kernels import epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for shape, dtype, noise_shape, pre, alpha, gain, clamp in cases:
        dt = getattr(torch, dtype)
        b, c = shape[:2]

        def rnd(*sh):
            return torch.randn(*sh, generator=gen, device="cuda")

        leaves = {"z": (rnd(*shape) * 4).to(dt), "post": rnd(b, c).abs() + 0.1,
                  "noise": None if noise_shape is None else rnd(*noise_shape), "bias": rnd(c) * 0.1,
                  "pre_next": rnd(b, c).abs() + 0.5 if pre else None, "g": rnd(*shape).to(dt)}
        v = {k: torch.randn(t.shape, generator=gen, device="cuda") for k, t in leaves.items() if t is not None}

        def second(fn):
            ts = {k: None if t is None else t.clone().requires_grad_(True) for k, t in leaves.items()}
            names = [k for k in ("z", "post", "noise", "bias", "pre_next") if ts[k] is not None]
            y = fn(ts["z"], ts["post"], ts["noise"], ts["bias"], alpha, gain, clamp, ts["pre_next"])
            first = torch.autograd.grad(y, [ts[k] for k in names], ts["g"], create_graph=True)
            total = sum((d.float() * v[k]).sum() for k, d in zip(names, first))
            wrt = [ts[k] for k in names + ["g"]]
            out = torch.autograd.grad(total, wrt, allow_unused=True) if total.requires_grad else [None] * len(wrt)
            return {k: torch.zeros_like(t, dtype=torch.float32) if d is None else d.float()
                    for k, t, d in zip(names + ["g"], wrt, out)}

        kernel, plain = second(E.modconv_epilogue), second(E.modconv_epilogue_plain)
        with swapped(E.ModconvEpilogue, "backward", staticmethod(detached_epilogue_backward)):
            detached = second(E.modconv_epilogue)

        def errs(got):
            return {f"d2{k}": float((got[k] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                    for k, ref in plain.items() if float(ref.abs().max()) > 0}

        bar = GRAD_BAR + (2.0**-8 if dt == torch.bfloat16 else 0.0)
        row = {"shape": list(shape), "dtype": dtype, "noise": noise_shape and list(noise_shape), "pre_next": pre,
               "clamp": clamp, "second_order_rel_err": errs(kernel), "detached_rel_err": errs(detached)}
        if max(row["second_order_rel_err"].values()) > bar:
            raise AssertionError(f"{what}: the epilogue's second-order gradient disagrees with the plain "
                                 f"version's at {row}")
        if max(row["detached_rel_err"].values()) <= bar:
            raise AssertionError(f"{what}: the bar does not reject the detached backward at {row}")
        rows.append(row)
        del leaves, v, kernel, plain, detached
        torch.cuda.empty_cache()
    E.reset_launches()
    return rows


GAN_TRAIN_STEPS = 5  # `gan train` steps at config-f 1024^2: R1 at step 0, path length at steps 0 and 4 (cut from 8)
GAN_TRAIN_IMAGES = 8  # the seed-made 1024^2 training folder: two batches an epoch
GAN_TRAIN_BATCH = 4
GAN_REF_SIZE = 64  # the train step held card vs CPU at 64^2 (channel_max 64)
# card vs CPU, TF32 off, at 64^2: each D and G gradient leaf of a step with R1, path length and the initial
# blur, over the larger of its largest magnitude and GAN_LEAF_FLOOR of its network's largest gradient: a scalar
# noise strength's gradient is a sum over every pixel that cancels to ~1e-2 of its siblings', and read alone it
# carries the roundoff of its terms (1.58e-2 at b16.conv0, H100 80GB HBM3, 700.00 W; every other leaf <= 6.2e-4);
# floored, G read 1.87e-4 and D 2.64e-6, and the detached (pre-repair) backward 1.08 in G
GAN_REF_BAR = 1e-3
GAN_REF_CUDNN_RUNS = 2  # the 64^2 step on cuDNN's default algorithms, read beside the held one, unbarred
GAN_LEAF_FLOOR = 1e-2
# the kernel route against the plain route on the card at 1024^2, TF32 off, floored as GAN_REF_BAR. The sound
# readings under cuDNN's default algorithms: the kernel route 4.2e-4 to 7.9e-3 over nine runs, the plain route
# against itself 3.9e-4 to 8.2e-4, every epilogue output one ulp off 4.3e-4 to 7.4e-3 (the spikes are b512's
# noise strengths, sums over every pixel that take cuDNN's atomics). Wrong routes: the detached backward
# 0.70-0.71, the noise input's gradient dropped 1.0 (at b1024's noise strengths: the floor does not hide them).
# H100 80GB HBM3, 700.00 W. Under cuDNN's deterministic algorithms (TF32 kept off: deterministic_kernels once let
# cudnn.flags turn it on, which alone moved the fakes by 0.03) the kernel route read 3.8e-4, the one-ulp witness
# 7.2e-3 and the f64 epilogue rounded once 7.1e-3, the fakes within 7.1e-5: held to the same bar
GAN_ROUTE_BAR = 3e-2
# one step resumed from the checkpoint against one from the state in memory, of each parameter leaf's largest
# magnitude: the inputs are equal bit for bit (checked) and the kernels deterministic, so it reads 0
GAN_RESUME_BAR = 1e-5


@contextlib.contextmanager
def deterministic_kernels():
    """cuDNN's deterministic algorithms, and PyTorch's deterministic kernels (a warning names any op that has
    none), within the block; cuDNN's TF32 setting stays the caller's (cudnn.flags would turn it on)."""
    import torch

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=torch.backends.cudnn.allow_tf32):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def leaf_names(tree, prefix: str = "") -> list:
    """The dotted names of a tree's tensors in tree_leaves' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def worst_leaf(errs: list, tree) -> str:
    return leaf_names(tree)[max(range(len(errs)), key=errs.__getitem__)]


def leaf_rel_errs(got, want, floor: float = 0.0) -> list:
    """|got - want| of each gradient leaf over the larger of its largest magnitude and `floor` times the
    tree's (an all-zero leaf over the tree's)."""
    scale = max(float(w.abs().max()) for w in want)
    return [float((g.float().cpu() - w.float().cpu()).abs().max()) / (max(float(w.abs().max()), floor * scale)
                                                                     or scale) for g, w in zip(got, want)]


def gan_grads(state, real, g_cfg, d_cfg, t_cfg, draws):
    """One train step's D and G gradients (and metrics) from copies of `state`'s tensors: with beta1 = 0, the
    new Adam first moments are the last D step's and the G step's gradients."""
    from maua_tpu_torch.gan import training as TT
    from maua_tpu_torch.utility import to_device

    if t_cfg.beta1 != 0.0:
        raise ValueError("gan_grads reads the gradients from Adam's first moment: beta1 must be 0")
    state = {k: to_device(v, real.device) if k != "step" else v for k, v in state.items()}
    new, metrics = TT.train_step(state, real, g_cfg, d_cfg, t_cfg, draws=draws)
    return {n: new[f"{n}_opt"][0]["mu"] for n in ("d", "g")}, {k: float(v) for k, v in metrics.items()}


def gan_draws(g_cfg, t_cfg, batch: int, gen):
    """A train step's draws (latents, per-layer noise maps, the path-length noise) from gen, on its device."""
    import torch

    def noises():
        return {f"b{r}.conv{j}": torch.randn(batch, 1, r, r, generator=gen, device=gen.device)
                for r in g_cfg.block_resolutions for j in ((1,) if r == 4 else (0, 1))}

    n = max(t_cfg.n_d_steps, 1)
    res = g_cfg.img_resolution
    return {"z_d": [torch.randn(batch, g_cfg.z_dim, generator=gen, device=gen.device) for _ in range(n)],
            "noise_d": [noises() for _ in range(n)],
            "z_g": torch.randn(batch, g_cfg.z_dim, generator=gen, device=gen.device), "noise_g": noises(),
            "pl_noise": torch.randn(max(batch // t_cfg.pl_batch_shrink, 1), 3, res, res, generator=gen,
                                    device=gen.device)}


def run_gan_train(tmp: str):
    """`python -m maua_tpu_torch gan train` (the command's main, in this process) at config-f 1024^2, batch 4,
    f32, on a folder of GAN_TRAIN_IMAGES seed-made images: GAN_TRAIN_STEPS steps at the default intervals (R1
    at step 0, path length at 0 and 4, the initial blur on), the one evaluation at the last step (64 images,
    the ResNet extractor) and the best and final checkpoints. Seconds a step by stage (D step, G step, EMA),
    peak memory, the epilogue's launches in all and under autograd (each counted one: a D step generates
    under no_grad, the G step and path length under autograd, the evaluation under no_grad); one plain and
    one regularized step profiled (idle share); the checkpoint round trip; one step from the loaded checkpoint
    against one from the state in memory, cuDNN deterministic: equal."""
    import io

    import numpy as np
    import torch
    from PIL import Image

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.gan import training as TT
    from maua_tpu_torch.gan import train_loop as TL
    from maua_tpu_torch.gan.data import ImageDataset, build_cache
    from maua_tpu_torch.kernels import epilogue as E

    stage, mark = {}, [time.perf_counter()]

    def lap(name):  # stage seconds, also to stderr as they pass
        now = time.perf_counter()
        stage[name] = now - mark[0]
        mark[0] = now
        print(json.dumps({"gan_train_stage": name, "seconds": stage[name]}), file=sys.stderr, flush=True)

    folder, out_dir = os.path.join(tmp, "gan_train_images"), os.path.join(tmp, "gan_train")
    os.makedirs(folder, exist_ok=True)
    for i in range(GAN_TRAIN_IMAGES):
        write_frame(os.path.join(folder, f"{i:03d}.png"), 1024, seed=100 + i)
    lap("images")
    steps, cfgs = [], {}
    real_step = TT.train_step

    def timed_step(state, real, g_cfg, d_cfg, t_cfg, **kw):
        cfgs.update(g=g_cfg, d=d_cfg, t=t_cfg)
        times = {}
        t0 = time.perf_counter()
        result = real_step(state, real, g_cfg, d_cfg, t_cfg, times=times, **kw)
        times["step"] = time.perf_counter() - t0
        steps.append(times)
        return result

    E.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    t0 = time.perf_counter()
    with swapped(TT, "train_step", timed_step), autograd_epilogue_cases() as cases, contextlib.redirect_stdout(log):
        state = command.main(["gan", "train", "--input_dir", folder, "--cache_dir", os.path.join(tmp, "gan_cache"),
                              "--resolution", "1024", "--batch_size", str(GAN_TRAIN_BATCH), "--total_steps",
                              str(GAN_TRAIN_STEPS), "--out_dir", out_dir])
    command_seconds = time.perf_counter() - t0
    lap("command")
    launches, autograd_launches = E.launches, sum(cases.values())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    g_cfg, d_cfg, t_cfg = cfgs["g"], cfgs["d"], cfgs["t"]
    layers = sum(g_cfg.block_num_conv(r) for r in g_cfg.block_resolutions)
    regularized = [i for i in range(GAN_TRAIN_STEPS) if i % t_cfg.pl_interval == 0]
    want_autograd = layers * (GAN_TRAIN_STEPS + len(regularized))
    want_all = want_autograd + layers * GAN_TRAIN_STEPS + layers * 64 // 16
    if (g_cfg.img_resolution, g_cfg.channel_max, g_cfg.dtype, d_cfg.img_resolution) != (1024, 512, "float32", 1024):
        raise AssertionError(f"gan_train: not config-f f32 at 1024^2: {g_cfg} {d_cfg}")
    if state["step"] != GAN_TRAIN_STEPS or (launches, autograd_launches) != (want_all, want_autograd):
        raise AssertionError(f"gan_train: step {state['step']}, epilogue launches {launches} (want {want_all}), "
                             f"under autograd {autograd_launches} (want {want_autograd})")
    eval_line = [line for line in log.getvalue().splitlines() if line.startswith("eval @")]
    scores = {kv.split("=")[0]: float(kv.split("=")[1]) for kv in eval_line[-1].split(": ")[1].split()}
    files = sorted(os.listdir(out_dir))
    grid = np.asarray(Image.open(os.path.join(out_dir, f"grid_{GAN_TRAIN_STEPS:07d}.png")))
    finite = all(bool(torch.isfinite(t).all()) for k in ("g_params", "d_params", "g_ema")
                 for t in TT.tree_leaves(state[k]))
    if not finite or not all(np.isfinite(v) for v in scores.values()) or grid.min() == grid.max() or \
            not {"ckpt_best.pt", "ckpt_final.pt"} <= set(files):
        raise AssertionError(f"gan_train: finite {finite}, scores {scores}, files {files}")

    # the checkpoint round trip, and one step from it against one from the state in memory
    lap("checks")
    t0 = time.perf_counter()
    TL.save_checkpoint(os.path.join(tmp, "gan_ckpt_copy.pt"), state)
    save_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = TL.load_checkpoint(os.path.join(out_dir, "ckpt_final.pt"), device="cuda")
    load_seconds = time.perf_counter() - t0
    tensors = assert_trees_equal({k: loaded[k] for k in ("g_params", "d_params", "g_ema")},
                                 {k: state[k] for k in ("g_params", "d_params", "g_ema")}, "gan checkpoint")
    for k in ("g_opt", "d_opt"):
        if loaded[k][0]["count"] != state[k][0]["count"] or not all(
                torch.equal(a, b) for m in ("mu", "nu") for a, b in zip(loaded[k][0][m], state[k][0][m])):
            raise AssertionError(f"gan checkpoint: {k} differs")
    if loaded["step"] != state["step"] or not torch.equal(loaded["pl_mean"], state["pl_mean"]):
        raise AssertionError("gan checkpoint: step or pl_mean differs")
    lap("checkpoint")
    real = next(iter(ImageDataset(build_cache(folder, 1024, cache_dir=os.path.join(tmp, "gan_cache")),
                                  GAN_TRAIN_BATCH, seed=3, prefetch=0)))
    # deterministic kernels (under PyTorch's defaults one reduction of the G step is not, and the two differed
    # in G): one step from the file, one from memory
    with deterministic_kernels():
        resumed, uninterrupted = (
            TT.train_step(st, real, g_cfg, d_cfg, t_cfg, gen=torch.Generator("cuda").manual_seed(7))[0]
            for st in (loaded, state))
    resume_diff = max(max(leaf_rel_errs(TT.tree_leaves(resumed[k]), TT.tree_leaves(uninterrupted[k])))
                      for k in ("g_params", "d_params", "g_ema"))
    if resume_diff > GAN_RESUME_BAR or resumed["step"] != uninterrupted["step"]:
        raise AssertionError(f"gan_train: the resumed step differs from the uninterrupted one by {resume_diff}")
    del resumed, uninterrupted, loaded
    lap("resume")

    def one_step(at):
        st = dict(state, step=at)
        return lambda: TT.train_step(st, real, g_cfg, d_cfg, t_cfg, gen=torch.Generator("cuda").manual_seed(1))

    profile = profile_batch(one_step(GAN_TRAIN_STEPS + 1), "epilogue")
    profile["top"] = profile.get("top", [])[:6]
    lap("profiles")
    by_kind = {"r1_pl": [0], "pl": [i for i in regularized if i % t_cfg.r1_interval], "plain": [
        i for i in range(GAN_TRAIN_STEPS) if i % t_cfg.pl_interval and i % t_cfg.r1_interval]}
    seconds = {kind: {k: float(np.mean([steps[i][k] for i in idx])) for k in ("step", "d_steps", "g_step", "ema")}
               for kind, idx in by_kind.items()}
    torch.cuda.empty_cache()
    return {"command_seconds": command_seconds, "steps": GAN_TRAIN_STEPS, "batch": GAN_TRAIN_BATCH,
            "seconds_per_step": seconds, "step_seconds": [round(t["step"], 4) for t in steps],
            "peak_memory_gib": peak_gib, "launches": launches, "launches_under_autograd": autograd_launches,
            "eval": scores, "files": files, "checkpoint_tensors": tensors, "checkpoint_save_seconds": save_seconds,
            "checkpoint_load_seconds": load_seconds, "resume_max_rel_diff": resume_diff,
            "plain_step_profile": profile, "stage_seconds": stage}


def run_gan_train_reference():
    """One train step (R1, path length and the initial blur on) card vs CPU at GAN_REF_SIZE^2 on the same
    state and draws, TF32 off, the card's convolutions on PyTorch's own CUDA kernels (on cuDNN its reading falls
    in one of two clusters from run to run: GAN_REF_CUDNN_RUNS readings on its default algorithms and one on
    its deterministic ones stand beside it, unbarred): D and G gradients leaf by leaf within GAN_REF_BAR (each
    over the larger of its largest magnitude and GAN_LEAF_FLOOR of its network's largest gradient); beside it
    the card (on cuDNN) with the detached (pre-repair) backward, whose reading the bar must reject. Then
    config-f 1024^2, batch 4, on the
    card, TF32 off, against the plain route's gradients (the epilogue's plain version through autograd): the
    kernel route, the plain route run again (cuDNN's atomics) and the plain route with every epilogue output
    one ulp off (forward rounding alone), each within GAN_ROUTE_BAR; the detached backward and the backward with
    the noise input's gradient dropped beyond it. Beside them the D step's fakes (each epilogue output against
    the f64 evaluation rounded once, and each route's images). Under cuDNN's deterministic algorithms (TF32 still
    off) the kernel route, the one-ulp witness and the f64 epilogue rounded once are read again, within the same
    bar."""
    import torch

    from maua_tpu_torch.gan import discriminator as D
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.gan import training as TT
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.utility import to_device

    out = {}
    t_cfg = TT.TrainConfig(blur_init_sigma=10.0)
    with tf32_off():
        g_cfg = S2.SG2Config(img_resolution=GAN_REF_SIZE, channel_max=64, num_fp16_res=0)
        d_cfg = D.D2Config(img_resolution=GAN_REF_SIZE, channel_max=64)
        state = TT.init_train_state(g_cfg, d_cfg, t_cfg, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        draws = gan_draws(g_cfg, t_cfg, GAN_TRAIN_BATCH, gen)
        real = torch.tanh(torch.randn(GAN_TRAIN_BATCH, 3, GAN_REF_SIZE, GAN_REF_SIZE, generator=gen))
        args = (real.cuda(), g_cfg, d_cfg, t_cfg, to_device(draws, "cuda"))
        on = {"cpu": gan_grads(state, real, g_cfg, d_cfg, t_cfg, draws)}
        # under cuDNN the card's reading falls, from run to run, on G 1.87e-4 or on 1.35e-3 (b64.conv1.weight),
        # the second every time under its deterministic algorithms (C11 in ROADMAP.md): the held step pins the
        # convolutions to PyTorch's own CUDA kernels (deterministic); cuDNN's readings stand beside it, unbarred
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            on["cuda"] = gan_grads(state, *args)
        with swapped(E.ModconvEpilogue, "backward", staticmethod(detached_epilogue_backward)):
            wrong, _ = gan_grads(state, *args)  # on cuDNN: the bar must reject it by far either way

        def cudnn_g():
            return max(leaf_rel_errs(gan_grads(state, *args)[0]["g"], on["cpu"][0]["g"], GAN_LEAF_FLOOR))

        cudnn = {"default": [cudnn_g() for _ in range(GAN_REF_CUDNN_RUNS)]}
        with deterministic_kernels():
            cudnn["deterministic"] = cudnn_g()
    ref = on["cpu"][0]
    small = {f"{n}_max_rel_err": max(leaf_rel_errs(on["cuda"][0][n], ref[n], GAN_LEAF_FLOOR)) for n in ("d", "g")}
    small["g_worst_leaf"] = worst_leaf(leaf_rel_errs(on["cuda"][0]["g"], ref["g"], GAN_LEAF_FLOOR), state["g_params"])
    small["g_leaf_max_rel_err_unfloored"] = max(leaf_rel_errs(on["cuda"][0]["g"], ref["g"]))
    small["detached_g_max_rel_err"] = max(leaf_rel_errs(wrong["g"], ref["g"], GAN_LEAF_FLOOR))
    small["metrics"] = {dev: m for dev, (_, m) in on.items()}
    small["card_convolutions"] = "PyTorch's CUDA kernels (cuDNN off), TF32 off"
    small["cudnn_g_max_rel_err_unbarred"] = cudnn
    if max(small["d_max_rel_err"], small["g_max_rel_err"]) > GAN_REF_BAR or \
            small["detached_g_max_rel_err"] <= GAN_REF_BAR:
        raise AssertionError(f"gan_train_reference: card vs CPU at {GAN_REF_SIZE}^2: {small}")
    out[f"card_vs_cpu_{GAN_REF_SIZE}"] = small
    del on, wrong, state

    g_cfg, d_cfg = S2.SG2Config(num_fp16_res=0), D.D2Config(img_resolution=1024)
    gen = torch.Generator("cuda").manual_seed(0)
    state = TT.init_train_state(g_cfg, d_cfg, t_cfg, gen)
    draws = gan_draws(g_cfg, t_cfg, GAN_TRAIN_BATCH, gen)
    real = torch.tanh(torch.randn(GAN_TRAIN_BATCH, 3, 1024, 1024, generator=gen, device="cuda"))
    ulp_gen = torch.Generator(device="cuda").manual_seed(3)

    def one_ulp_off(*a, **k):  # the plain version's output moved one ulp, each element a random way
        y = E.modconv_epilogue_plain(*a, **k)
        yd, up = y.detach(), torch.rand(y.shape, generator=ulp_gen, device=y.device) < 0.5
        return y + (torch.nextafter(yd, torch.where(up, math.inf, -math.inf).to(yd)) - yd)

    real_backward = E.ModconvEpilogue.backward

    def without_dnoise(ctx, g):  # a wrong route: the noise input's gradient dropped
        grads = list(real_backward(ctx, g))
        grads[2] = None if grads[2] is None else torch.zeros_like(grads[2])
        return tuple(grads)

    def plain_as(fn):
        return lambda: swapped(S2, "modconv_epilogue", fn)

    routes = {"kernel": contextlib.nullcontext, "plain": plain_as(E.modconv_epilogue_plain),
              "plain_one_ulp_off": plain_as(one_ulp_off), "plain_rounded_once": plain_as(epilogue_rounded_once),
              "detached": lambda: swapped(E.ModconvEpilogue, "backward", staticmethod(detached_epilogue_backward)),
              "without_dnoise": lambda: swapped(E.ModconvEpilogue, "backward", staticmethod(without_dnoise))}
    routes["plain_again"] = routes["plain"]

    def readings(names):
        """Each route's D and G gradients against the plain route's under the flags in force: the largest
        floored leaf error of each network, its leaf, G's largest unfloored one and the route's launches."""
        grads, launches = {}, {}
        for name in ["plain", *names]:
            E.reset_launches()
            with routes[name]():
                grads[name], _ = gan_grads(state, real, g_cfg, d_cfg, t_cfg, draws)
            launches[name] = E.launches
        ref, rows = grads.pop("plain"), {}
        for name, got in grads.items():
            errs = {n: leaf_rel_errs(got[n], ref[n], GAN_LEAF_FLOOR) for n in ("d", "g")}
            rows[name] = {"d": max(errs["d"]), "g": max(errs["g"]),
                          "d_worst_leaf": worst_leaf(errs["d"], state["d_params"]),
                          "g_worst_leaf": worst_leaf(errs["g"], state["g_params"]),
                          "g_unfloored": max(leaf_rel_errs(got["g"], ref["g"])), "launches": launches[name]}
        return rows

    def forward_reading():
        """The D step's fakes under no_grad: each epilogue output of the kernel and of the plain version against
        the f64 evaluation rounded once (the largest difference over the layer's largest magnitude, and the mean
        difference in ulps of each element, absolute and signed); then the images of each route against the
        plain route's, largest difference."""
        ulps = {r: {"max_of_layer_peak": 0.0, "mean_abs_ulps": [], "mean_signed_ulps": []} for r in ("kernel", "plain")}

        def spy(z, post, noise, bias, alpha=0.2, gain=math.sqrt(2.0), clamp=256.0, pre_next=None):
            args = (z, post, noise, bias, alpha, gain, clamp, pre_next)
            k, p, x = E._launch(*args), E.modconv_epilogue_plain(*args), epilogue_rounded_once(*args)
            ulp = torch.nextafter(x.abs(), x.new_full((), math.inf)) - x.abs()
            for r, y in (("kernel", k), ("plain", p)):
                ulps[r]["max_of_layer_peak"] = max(ulps[r]["max_of_layer_peak"],
                                                   float((y - x).abs().max() / x.abs().max()))
                ulps[r]["mean_abs_ulps"].append(float(((y - x).abs() / ulp).mean()))
                ulps[r]["mean_signed_ulps"].append(float(((y - x) / ulp).mean()))
            return k

        with torch.no_grad():
            def fakes():
                return TT.generate(state["g_params"], draws["z_d"][0], g_cfg, noises=draws["noise_d"][0])

            with swapped(S2, "modconv_epilogue", spy):
                fakes()
            imgs = {}
            for name in ("plain", "kernel", "plain_one_ulp_off", "plain_rounded_once"):
                with routes[name]():
                    imgs[name] = fakes()
        for r in ulps.values():
            r["mean_abs_ulps"], r["mean_signed_ulps"] = max(r["mean_abs_ulps"]), max(r["mean_signed_ulps"], key=abs)
        return {"epilogue_vs_rounded_once": ulps,
                "image_max_abs_vs_plain": {k: float((v - imgs["plain"]).abs().max()) for k, v in imgs.items()}}

    with tf32_off():
        default = readings(["kernel", "plain_again", "plain_one_ulp_off", "detached", "without_dnoise"])
        default["forward"] = forward_reading()
        with deterministic_kernels():
            deterministic = readings(["kernel", "plain_one_ulp_off", "plain_rounded_once"])
            deterministic["forward"] = forward_reading()
    big = {"default_flags": default, "deterministic": deterministic}
    sound = [max(default[k]["d"], default[k]["g"]) for k in ("kernel", "plain_again", "plain_one_ulp_off")]
    sound += [max(deterministic[k]["d"], deterministic[k]["g"]) for k in ("kernel", "plain_one_ulp_off",
                                                                         "plain_rounded_once")]
    wrong = [default[k]["g"] for k in ("detached", "without_dnoise")]
    if max(sound) > GAN_ROUTE_BAR or min(wrong) <= GAN_ROUTE_BAR or default["kernel"]["launches"] == 0:
        raise AssertionError(f"gan_train_reference: kernel vs plain route at 1024^2 (bar {GAN_ROUTE_BAR}): {big}")
    out["kernel_vs_plain_1024"] = big
    E.reset_launches()
    torch.cuda.empty_cache()
    return out


def run_gan_langevin_d(tmp: str):
    """`python -m maua_tpu_torch gan generate --sampling langevin --langevin_critic discriminator --seeds 0-2` on
    an ADA .pkl written as gan_load writes it (config-f G from seed 0) with a `D` entry (a config-f 1024^2
    discriminator from seed 1): the command's 50 Langevin steps with E(z) = -D(G(z)), two PNGs, seconds, the
    epilogue's launches in all and under autograd (17 a step)."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.gan import discriminator as D
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.kernels import epilogue as E

    g_cfg, d_cfg = S2.SG2Config(), D.D2Config(img_resolution=1024)
    cpu = lambda t: t.cpu()  # noqa: E731
    g = tree_map(cpu, S2.init_params(g_cfg, torch.Generator("cuda").manual_seed(0)))
    d = tree_map(cpu, D.init_params(d_cfg, torch.Generator("cuda").manual_seed(1)))
    path, out_dir = os.path.join(tmp, "sg2_ada_with_d.pkl"), os.path.join(tmp, "gan_langevin_d")
    write_ada_pkl(path, ada_state_dict(g), ada_d_state_dict(d, d_cfg))
    E.reset_launches()
    t0 = time.perf_counter()
    with autograd_epilogue_cases() as cases:
        command.main(["gan", "generate", "--model_file", path, "--sampling", "langevin", "--langevin_critic",
                      "discriminator", "--seeds", LANGEVIN_SEEDS, "--out_dir", out_dir])
    seconds = time.perf_counter() - t0
    imgs = [np.asarray(Image.open(os.path.join(out_dir, f))) for f in sorted(os.listdir(out_dir))]
    if len(imgs) != 2 or any(im.shape != (1024, 1024, 3) or im.min() == im.max() for im in imgs) or \
            imgs[0].tobytes() == imgs[1].tobytes():
        raise AssertionError(f"gan_langevin_d: {[im.shape for im in imgs]}")
    under = sum(cases.values())
    if under != 17 * 50:
        raise AssertionError(f"gan_langevin_d: {under} epilogue launches under autograd, want {17 * 50}")
    return {"command_seconds": seconds, "pngs": len(imgs), "launches": E.launches, "launches_under_autograd": under,
            "cases_under_autograd": len(cases)}


# ------------------------------------------------------------ autoregressive text-to-image and video, GAN extras
AUTOREG_PROMPT = "a lighthouse on a cliff at dusk, oil painting"
AUTOREG_BATCH = 4
AUTOREG_TOP_K = 64
AUTOREG_PROFILE_STEPS = 8
AUTOREG_LOGIT_TOL = 1e-4  # transformer logits card vs CPU, TF32 off: of the largest magnitude
AUTOREG_FT_STEPS = 4  # finetune_step's at ruDALL-E Malevich's widths, int8 Adam
AUTOREG_FT_BATCH = 2
AUTOREG_CLI_FT_STEPS = 20  # `autoregressive finetune` steps at the CLI's config (its default is 100)
ICGAN_CLIP_STEPS = 20
ICGAN_BATCH = 8
SD_FT_STEPS = 3
SD_FT_SAMPLE_STEPS = 5  # LMS steps of the validation sample
SD_FT_RESUME_DEPTH = {"channel_mult": (1, 2), "num_res_blocks": 1}  # SD1_UNET cut for the resume check
TRANSPORT_SIZE = 1024
TRANSPORT_ITERS = 8
TRANSPORT_TOL = 1e-4  # covariance modes card vs CPU: of the largest magnitude


def autoreg_configs():
    """ruDALL-E Malevich's transformer widths (1.31 B parameters) and its VQGAN as far as VQConfig
    expresses it (256^2 images from a 32 x 32 grid)."""
    from maua_tpu_torch.autoregressive.transformer import ARConfig
    from maua_tpu_torch.autoregressive.vq import VQConfig

    return (ARConfig(vocab_size=8192, text_vocab_size=16384, text_length=128, image_rows=32, image_cols=32,
                     width=2048, layers=24, heads=16),
            VQConfig(codebook_size=8192, z_channels=256, base_channels=128, channel_mult=(1, 1, 2, 4),
                     num_res_blocks=2))


def cuda_kernel_count(prof) -> int:
    """The device kernels in a profile (copies and memsets not counted)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "[memory]")))


def run_autoreg():
    """The slice's main path at ruDALL-E Malevich's widths, f32, TF32 off, seed-0 weights: prefill 127 text
    tokens and sample 1024 image tokens for a batch of 4 with the KV cache at top-k 64
    (`transformer.generate_tokens`), decode them to 256^2 with the VQ decoder (its (4, 1, 1024, 512) mid
    attention on the kernel route) and CLIP-rerank the 4 images to 2 (ViT-B/32). Seconds of each stage,
    tokens/s against the step's bytes bound (every weight read once a step), launches a step and the
    device's idle share over 8 profiled steps, peak memory, and the attention kernel's launches (reset
    before, read after), each case held against the plain version."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maua_tpu_torch.autoregressive import cli as ARC
    from maua_tpu_torch.autoregressive import rerank as RR
    from maua_tpu_torch.autoregressive import transformer as AT
    from maua_tpu_torch.autoregressive import vq as VQ
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.perceptors.clip import CLIPPerceptor

    cfg, vq_cfg = autoreg_configs()
    with tf32_off():
        t0 = time.perf_counter()
        params = AT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        vq_params = VQ.params_from_torch(taming_state_dict(VQ.init_params(
            vq_cfg, torch.Generator(device="cuda").manual_seed(1))), vq_cfg)
        vq_params = tree_map(lambda t: t.cuda(), vq_params)
        perceptor = CLIPPerceptor(device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        text = ARC._text_tokens(AUTOREG_PROMPT, cfg, "cuda").repeat(AUTOREG_BATCH, 1)
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        A.reset_launches()
        with attention_cases_recorded() as cases:
            toks = AT.generate_tokens(params, text, cfg, torch.Generator(device="cuda").manual_seed(0),
                                      top_k=AUTOREG_TOP_K, stage_times=stages)
            t0 = time.perf_counter()
            imgs = VQ.decode_tokens(vq_params, toks, vq_cfg, cfg.image_rows, cfg.image_cols)
            torch.cuda.synchronize()
            stages["decode"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            best = RR.clip_rerank(imgs, AUTOREG_PROMPT, top_n=2, perceptor=perceptor)
            torch.cuda.synchronize()
            stages["rerank"] = time.perf_counter() - t0
        launches = A.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        t = toks.cpu().numpy()
        if (t.shape != (AUTOREG_BATCH, cfg.image_length) or t.min() < 0 or t.max() >= cfg.vocab_size
                or imgs.shape != (AUTOREG_BATCH, 3, cfg.image_rows * vq_cfg.upscale, cfg.image_cols * vq_cfg.upscale)
                or not bool(torch.isfinite(imgs).all())
                or float(imgs.abs().max()) > 1.0 or len(set(best.tolist())) != 2):
            raise AssertionError(f"autoreg: tokens {t.shape}, images {tuple(imgs.shape)}, rerank {best}")
        want_case = [k for k in cases if k[2][0] == (AUTOREG_BATCH, 1, cfg.image_length, 512)]
        if launches != 1 or sum(cases.values()) != 1 or not want_case:
            raise AssertionError(f"autoreg: {launches} attention launches in the decode, cases {dict(cases)}")
        attention = check_attention_cases(cases, "autoreg")

        # 8 decode steps as generate_tokens takes them (kv_step and the top-k draw), profiled
        pos_tab = AT.position_table(params, cfg, cfg.total_length)
        n = cfg.text_length - 1
        caches = AT.kv_prefill(params, cfg, params["tok_emb"][text[:, :n]] + pos_tab[None, :n], cfg.total_length)
        draw = AT.gumbel_draws(torch.Generator(device="cuda").manual_seed(1))
        tok, p = text[:, -1], n

        def step(tok, p):
            logits, _ = AT.kv_step(params, cfg, params["tok_emb"][tok] + pos_tab[p], p, caches)
            return AT.sample_logits(logits[:, cfg.text_vocab_size:], draw, 1.0, AUTOREG_TOP_K) + cfg.text_vocab_size

        for _ in range(2):
            tok, p = step(tok, p), p + 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(AUTOREG_PROFILE_STEPS):
                tok, p = step(tok, p), p + 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = device_busy_ms(prof)
        kernels = cuda_kernel_count(prof)
    del params, caches
    torch.cuda.empty_cache()
    bound_step_ms = 4 * n_params / HBM_BYTES_PER_S * 1e3
    tokens = AUTOREG_BATCH * cfg.image_length
    return {"parameters": n_params, "weights_gb": 4 * n_params / 1e9, "init_seconds": init_s,
            **{f"{k}_seconds": v for k, v in stages.items()},
            "tokens_per_s": tokens / stages["sampling"], "step_ms": stages["sampling"] / cfg.image_length * 1e3,
            "bound_step_ms": bound_step_ms, "bound_tokens_per_s": AUTOREG_BATCH / (bound_step_ms / 1e3),
            "profiled_steps": AUTOREG_PROFILE_STEPS, "profiled_wall_ms_per_step": wall_ms / AUTOREG_PROFILE_STEPS,
            "profiled_busy_ms_per_step": busy_ms / AUTOREG_PROFILE_STEPS,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms) if busy_ms else "not measured",
            "launches_per_step": kernels / AUTOREG_PROFILE_STEPS, "peak_gib": peak_gib,
            "rerank_best": best.tolist(), "decode_launches": launches, "attention_cases": attention,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention)}


def run_autoreg_reference():
    """At ruDALL-E's widths with 2 layers over a 16 x 16 grid, batch 2: the KV-cached and the recompute
    samplers give the same tokens on the same draws; one oversampled decode to 24 of the 16 native
    columns (the VQ decoder at full width); one RQ encode and decode at depth 4 of a 256^2 seed image
    (its first level the depth-1 codes, its mid attentions on the kernel route, each case held against
    the plain version). Then transformer logits card vs CPU at ARConfig's defaults, TF32 off."""
    import dataclasses

    import numpy as np
    import torch

    from maua_tpu_torch.autoregressive import oversample as OV
    from maua_tpu_torch.autoregressive import transformer as AT
    from maua_tpu_torch.autoregressive import vq as VQ
    from maua_tpu_torch.kernels import attention as A

    cfg, vq_cfg = autoreg_configs()
    cfg2 = dataclasses.replace(cfg, layers=2, image_rows=16, image_cols=16)
    out = {}
    with tf32_off():
        params = AT.init_params(cfg2, torch.Generator(device="cuda").manual_seed(2))
        text = torch.randint(0, cfg2.text_vocab_size, (2, cfg2.text_length), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(3))
        gumbel = AT.gumbel_draws(torch.Generator(device="cuda").manual_seed(4))
        draws = [gumbel((2, cfg2.vocab_size)) for _ in range(cfg2.image_length)]
        toks = {}
        for cached in (True, False):
            t0 = time.perf_counter()
            toks[cached] = AT.generate_tokens(params, text, cfg2, top_k=AUTOREG_TOP_K, cached=cached,
                                              draw=lambda shape, it=iter(draws): next(it))
            out[f"{'cached' if cached else 'recompute'}_seconds"] = time.perf_counter() - t0
        if not torch.equal(toks[True], toks[False]):
            raise AssertionError(f"autoreg_reference: cached and recompute tokens differ at "
                                 f"{int((toks[True] != toks[False]).sum())} positions")
        vq_params = VQ.init_params(vq_cfg, torch.Generator(device="cuda").manual_seed(1))
        t0 = time.perf_counter()
        grid = OV.oversample_generate(params, text, cfg2, target_cols=24, top_k=AUTOREG_TOP_K,
                                      gen=torch.Generator(device="cuda").manual_seed(5))
        wide = VQ.decode_tokens(vq_params, grid.reshape(2, -1), vq_cfg, 16, 24)
        torch.cuda.synchronize()
        out["oversample_seconds"] = time.perf_counter() - t0
        u = vq_cfg.upscale
        if grid.shape != (2, 16, 24) or wide.shape != (2, 3, 16 * u, 24 * u) or not bool(torch.isfinite(wide).all()):
            raise AssertionError(f"autoreg_reference: oversampled grid {tuple(grid.shape)}, images {tuple(wide.shape)}")
        del params
        side = cfg.image_rows * vq_cfg.upscale  # 256: a 32 x 32 grid
        img = torch.tanh(torch.randn(1, 3, side, side, generator=torch.Generator(device="cuda").manual_seed(6),
                                     device="cuda"))
        A.reset_launches()
        with attention_cases_recorded() as cases:
            codes = {d: VQ.encode_rq_tokens(vq_params, img, vq_cfg, d) for d in (1, 4)}
            rq = VQ.decode_rq_tokens(vq_params, codes[4], vq_cfg, cfg.image_rows, cfg.image_cols, 4)
        launches = A.launches
        z = VQ._latents(vq_params, img, vq_cfg)
        resid = {d: float((z - vq_params["codebook"][codes[d].reshape(-1, d)].sum(1)).norm()) for d in (1, 4)}
        first = codes[4].reshape(-1, 4)[:, 0]  # the first level snaps the latent itself, as depth 1 does
        if (rq.shape != img.shape or not bool(torch.isfinite(rq).all()) or not torch.equal(first, codes[1].reshape(-1))
                or launches != 3 or sum(cases.values()) != 3):
            raise AssertionError(f"autoreg_reference: RQ {tuple(rq.shape)}, residuals {resid}, {launches} launches")
        out["rq"] = {"depth": 4, "residual_norm": resid, "launches": launches,
                     "attention_cases": check_attention_cases(cases, "autoreg_reference")}
        small = AT.ARConfig()
        cpu_params = AT.init_params(small, torch.Generator().manual_seed(7))
        tokens = torch.randint(0, small.total_vocab, (2, small.total_length),
                               generator=torch.Generator().manual_seed(8))
        want = AT.forward(cpu_params, tokens, small)
        got = AT.forward(tree_map(lambda t: t.cuda(), cpu_params), tokens.cuda(), small).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= AUTOREG_LOGIT_TOL:
            raise AssertionError(f"autoreg_reference: logits card vs CPU {err}")
        out["logits_card_vs_cpu_rel_err"] = err
    return out


def run_autoreg_video(tmp: str):
    """`python -m maua_tpu_torch autoregressive video` at its own configuration (3 keyframes, 1
    interpolation round: 5 frames, --guidance_alpha 1.5): seconds, frames and the mp4. Then both stages at
    that configuration with the KV-cached and the recompute fills on the same draws: equal tokens."""
    import numpy as np
    import torch

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.autoregressive import video as AV
    from maua_tpu_torch.autoregressive.cli import word_id
    from maua_tpu_torch.autoregressive.transformer import ARConfig, init_params

    out_dir = os.path.join(tmp, "autoreg_video")
    t0 = time.perf_counter()
    command.main(["autoregressive", "video", "--text", AUTOREG_PROMPT, "--n_keyframes", "3",
                  "--interpolation_rounds", "1", "--guidance_alpha", "1.5", "--out_dir", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    frames = sorted(f for f in os.listdir(out_dir) if f.startswith("frame_"))
    if len(frames) != 5 or not os.path.getsize(os.path.join(out_dir, "video.mp4")):
        raise AssertionError(f"autoreg_video: {os.listdir(out_dir)}")
    cfg = ARConfig(width=128, layers=2, heads=4, image_rows=8, image_cols=8, text_length=16, max_frames=5)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    text = np.asarray([[word_id(w, cfg.text_vocab_size - 1) for w in AUTOREG_PROMPT.split()]
                       + [0] * (cfg.text_length - len(AUTOREG_PROMPT.split()))])
    guider = np.asarray([[word_id("video", cfg.text_vocab_size - 1)] + [0] * (cfg.text_length - 1)])
    tokens, fill_s = {}, {}
    for cached in (True, False):
        t0 = time.perf_counter()
        keys = AV.generate_video_tokens(params, text, cfg, 3, gen=torch.Generator(device="cuda").manual_seed(1),
                                        guider_text_tokens=guider, guidance_alpha=1.5, cached=cached)
        tokens[cached] = AV.interpolate_frames(params, keys, text, cfg, cached=cached,
                                               gen=torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
        fill_s["cached" if cached else "recompute"] = time.perf_counter() - t0
    if tokens[True].shape != (5, 1, cfg.image_length) or not torch.equal(tokens[True], tokens[False]):
        raise AssertionError("autoreg_video: the cached and recompute fills differ")
    return {"command_seconds": seconds, "frames": len(frames), "fill_seconds": fill_s}


def run_autoreg_finetune(tmp: str):
    """`python -m maua_tpu_torch autoregressive finetune` on 4 seed-made 32^2 images at the CLI's
    configuration (AUTOREG_CLI_FT_STEPS steps, batch 2, then 2 samples), with and without --adam8bit; then
    AUTOREG_FT_STEPS finetune_step's at ruDALL-E Malevich's widths with int8 Adam on seed-made token rows
    (batch 2, 1152 tokens): seconds a step, peak memory, the frozen leaves unchanged."""
    import numpy as np
    import torch
    from PIL import Image

    from maua_tpu_torch import __main__ as command
    from maua_tpu_torch.autoregressive import finetune as FT
    from maua_tpu_torch.autoregressive import transformer as AT

    rs = np.random.RandomState(9)
    paths = []
    for i in range(4):
        paths.append(os.path.join(tmp, f"autoreg_ft_{i}.png"))
        Image.fromarray(rs.randint(0, 256, (32, 32, 3)).astype(np.uint8)).save(paths[-1])
    out = {}
    for adam8bit in (False, True):
        tag = "adam8bit" if adam8bit else "adamw"
        save = os.path.join(tmp, f"autoreg_ft_{tag}.npz")
        t0 = time.perf_counter()
        command.main(["autoregressive", "finetune", "--images", *paths, "--captions", "a", "b", "c", "d",
                      "--steps", str(AUTOREG_CLI_FT_STEPS), "--train_batch_size", "2", "--save_path", save,
                      "--num_outputs", "2", "--output_dir", os.path.join(tmp, f"autoreg_ft_{tag}")]
                     + (["--adam8bit"] if adam8bit else []))
        torch.cuda.synchronize()
        out[f"command_{tag}_seconds"] = time.perf_counter() - t0
        if not os.path.exists(save) or len(os.listdir(os.path.join(tmp, f"autoreg_ft_{tag}"))) != 2:
            raise AssertionError(f"autoreg_finetune: the {tag} command wrote {os.listdir(tmp)}")
    cfg, _ = autoreg_configs()
    params = AT.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ft = FT.FinetuneConfig(lr=1e-5, steps=AUTOREG_FT_STEPS, adam8bit=True)
    gen = torch.Generator(device="cuda").manual_seed(10)
    tokens = torch.cat([torch.randint(0, cfg.text_vocab_size, (AUTOREG_FT_BATCH, cfg.text_length), generator=gen,
                                      device="cuda"),
                        torch.randint(0, cfg.vocab_size, (AUTOREG_FT_BATCH, cfg.image_length), generator=gen,
                                      device="cuda") + cfg.text_vocab_size], 1)
    torch.cuda.reset_peak_memory_stats()
    state = FT.init_finetune_state(params, ft)
    first = [t.clone() for t in _leaves(state["params"]["blocks"][0]["qkv"])]
    first.append(state["params"]["head"]["w"][:4].clone())
    seconds, losses = [], []
    for _ in range(AUTOREG_FT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = FT.finetune_step(state, tokens, cfg, ft)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    qkv = _leaves(state["params"]["blocks"][0]["qkv"])
    if (not all(math.isfinite(x) for x in losses) or not all(torch.equal(a, b) for a, b in zip(first[:2], qkv))
            or torch.equal(first[2], state["params"]["head"]["w"][:4])):
        raise AssertionError(f"autoreg_finetune: losses {losses}, frozen or trained leaves wrong")
    return {**out, "step_seconds": seconds, "losses": losses, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "batch": AUTOREG_FT_BATCH, "tokens_per_row": cfg.total_length}


def run_gan_icgan(tmp: str):
    """IC-GAN's BigGAN at its 256^2 widths (BigGANConfig()) from a synthetic BigGAN-PyTorch state dict with
    u0, sv0, stored_mean and stored_var (seed-made, attention gamma 0.5), a batch of 8 on the card against
    the CPU (TF32 off, PSNR at peak 2); then the StyleGAN2 backbone (128^2, c_dim 256): instance features
    of 4 seed images, `generate` (2 an instance) and ICGAN_CLIP_STEPS `icgan_clip` steps with CLIP ViT-B/32,
    the epilogue's launches and those under autograd, each case held against the plain version."""
    import numpy as np
    import torch

    from maua_tpu_torch.gan import biggan as BG
    from maua_tpu_torch.gan import icgan as IC
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.perceptors.clip import CLIPPerceptor

    cfg = BG.BigGANConfig()
    gen = torch.Generator().manual_seed(11)
    params = BG.init_params(cfg, gen)
    for blk in params["blocks"]:
        for bn in ("bn1", "bn2"):
            blk[bn]["mean"] = torch.randn(blk[bn]["mean"].shape, generator=gen) * 0.1
            blk[bn]["var"] = 1 + torch.randn(blk[bn]["var"].shape, generator=gen).abs() * 0.2
    params["attention"]["gamma"] = torch.tensor(0.5)
    path = os.path.join(tmp, "icgan_biggan.pth")
    torch.save({"state_dict": biggan_state_dict(params, cfg, sv0=True, seed=12)}, path)
    z = torch.randn(ICGAN_BATCH, cfg.dim_z, generator=gen)
    feats = torch.randn(ICGAN_BATCH, cfg.feature_dim, generator=gen)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    with tf32_off():
        card = IC.load_icgan(path, backbone="biggan", biggan_cfg=cfg, device="cuda")
        cpu = IC.load_icgan(path, backbone="biggan", biggan_cfg=cfg, device="cpu")
        with torch.no_grad():
            a = card(z.cuda(), feats.cuda())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = card(z.cuda(), feats.cuda()).cpu()
            biggan_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = cpu(z, feats)
            cpu_s = time.perf_counter() - t0
    psnr = psnr_db(a.numpy(), b.numpy(), 2.0)
    if a.shape != (ICGAN_BATCH, 3, 256, 256) or not psnr >= 40.0:
        raise AssertionError(f"gan_icgan: BigGAN {tuple(a.shape)}, card vs CPU {psnr} dB")
    del card, cpu
    g = IC.load_icgan(device="cuda")
    imgs = torch.tanh(torch.randn(4, 3, 128, 128, generator=torch.Generator(device="cuda").manual_seed(13),
                                  device="cuda"))
    inst = IC.instance_features(imgs, dim=g.cfg.c_dim)
    E.reset_launches()
    with epilogue_cases_recorded() as cases:
        out_imgs = IC.generate(g, inst, n_per_instance=2, rng=torch.Generator(device="cuda").manual_seed(14))
        torch.cuda.synchronize()
    per_generate = E.launches
    rows, worst = check_epilogue_cases(cases, "gan_icgan")
    perceptor = CLIPPerceptor(device="cuda")
    E.reset_launches()
    with autograd_epilogue_cases() as grad_cases:
        t0 = time.perf_counter()
        clip_imgs, lat = IC.icgan_clip(g, LANGEVIN_PROMPT, perceptor=perceptor, n_steps=ICGAN_CLIP_STEPS, batch=4,
                                       rng=torch.Generator(device="cuda").manual_seed(15), verbose=False)
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
    launches, under = E.launches, sum(grad_cases.values())
    if (out_imgs.shape != (8, 3, 128, 128) or clip_imgs.shape != (4, 3, 128, 128) or per_generate == 0
            or under != ICGAN_CLIP_STEPS * per_generate or launches != under + per_generate
            or not bool(torch.isfinite(clip_imgs).all())):
        raise AssertionError(f"gan_icgan: {per_generate} launches a generate, {launches} in icgan_clip, "
                             f"{under} under autograd")
    return {"biggan_batch_seconds": biggan_s, "biggan_cpu_seconds": cpu_s, "biggan_card_vs_cpu_psnr_db": psnr,
            "generate_launches": per_generate, "launches_per_image": per_generate / out_imgs.shape[0],
            "epilogue_cases": rows, "epilogue_max_abs_err": worst, "icgan_clip_seconds": clip_s,
            "icgan_clip_seconds_per_step": clip_s / ICGAN_CLIP_STEPS, "icgan_clip_launches": launches,
            "launches_under_autograd": under, "gradient_cases": check_epilogue_gradients(grad_cases, "gan_icgan")}


def run_sd_finetune(tmp: str):
    """SD 1.x at the CompVis v1-inference widths (random weights from seed 0), 512^2 images (64^2
    latents), batch 1, f32, cuDNN's deterministic algorithms: SD_FT_STEPS finetune steps with the EMA and
    the validation sample once (SD_FT_SAMPLE_STEPS LMS steps). The resume check runs at a cut depth
    (SD_FT_RESUME_DEPTH: the widths' first two levels, one residual block each; the full width's 13.75
    GB state cost ~59 s of host I/O): SD_FT_STEPS uninterrupted steps, the same run as SD_FT_STEPS - 1
    steps, the torch.save state, and a resumed last step, which must equal the uninterrupted run. Seconds a step, peak memory,
    the checkpoint's size and seconds, and the attention kernel's launches under autograd (10 a step at
    full width), each such case's dq, dk, dv held against the plain version."""
    import dataclasses

    import numpy as np
    import torch

    from maua_tpu_torch.diffusion import finetune as DF
    from maua_tpu_torch.diffusion.models import unet as U
    from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
    from maua_tpu_torch.kernels import attention as A

    proc = StableDiffusion(device="cuda", seed=0, timesteps=SD_FT_SAMPLE_STEPS, image_size=512)
    init = tree_map(torch.clone, proc.unet_params)
    rs = np.random.RandomState(16)
    imgs = np.tanh(rs.randn(2, 512, 512, 3)).astype(np.float32)
    captions = [SD_PROMPT, "a red fox in the snow"]
    hooks = []
    det = torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True)

    def run(n_steps, gen, **kw):
        proc.unet_params = tree_map(torch.clone, init) if not kw.get("resume") else proc.unet_params
        return DF.finetune(proc, imgs, captions, n_steps=n_steps, batch_size=1, lr=1e-5, gen=gen, verbose=False,
                           **kw)

    def cut_run(n_steps, gen, **kw):
        small.unet_params = tree_map(torch.clone, small_init) if not kw.get("resume") else small.unet_params
        return DF.finetune(small, imgs, captions, n_steps=n_steps, batch_size=1, lr=1e-5, gen=gen, verbose=False,
                           **kw)

    torch.cuda.reset_peak_memory_stats()
    with det:
        A.reset_launches()
        with autograd_attention_cases() as cases:
            t0 = time.perf_counter()
            full = run(SD_FT_STEPS, torch.Generator(device="cuda").manual_seed(17), sample_every=SD_FT_STEPS,
                       sample_hook=lambda step, im: hooks.append((step, im.shape, bool(np.isfinite(im).all()))))
            torch.cuda.synchronize()
            full_s = time.perf_counter() - t0
        launches, under = A.launches, sum(cases.values())
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del full
        proc.unet_params = None
        del init
        torch.cuda.empty_cache()
        small = StableDiffusion(device="cuda", seed=0, timesteps=SD_FT_SAMPLE_STEPS, image_size=512,
                                unet_cfg=dataclasses.replace(U.SD1_UNET, **SD_FT_RESUME_DEPTH),
                                vae_params=proc.vae_params, text_params=proc.text_params)
        small_init = tree_map(torch.clone, small.unet_params)
        full = tree_map(lambda t: t.cpu(), list(cut_run(SD_FT_STEPS, torch.Generator(device="cuda").manual_seed(17))))
        ckpt = os.path.join(tmp, "sd_finetune")
        gen = torch.Generator(device="cuda").manual_seed(17)
        t0 = time.perf_counter()
        cut_run(SD_FT_STEPS - 1, gen, checkpoint_dir=ckpt)
        torch.cuda.synchronize()
        part_s = time.perf_counter() - t0
        size_gb = os.path.getsize(os.path.join(ckpt, "finetune_last.pt")) / 1e9
        t0 = time.perf_counter()
        resumed = cut_run(SD_FT_STEPS, gen, checkpoint_dir=ckpt, resume=True)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    diff = max(float((a - b.cpu()).abs().max()) for a, b in zip(_leaves(full), _leaves(list(resumed))))
    if hooks != [(SD_FT_STEPS, (1, 512, 512, 3), True)] or diff != 0.0 or small.unet_params is not resumed[1]:
        raise AssertionError(f"sd_finetune: hook {hooks}, resumed run {diff} from the uninterrupted one")
    if under != 10 * SD_FT_STEPS or launches < under:
        raise AssertionError(f"sd_finetune: {launches} attention launches, {under} under autograd")
    del full, resumed, small_init
    small.unet_params = None
    torch.cuda.empty_cache()
    return {"run_seconds": full_s, "seconds_per_step_with_sample": full_s / SD_FT_STEPS, "peak_gib": peak_gib,
            "partial_run_seconds": part_s, "resume_seconds": resume_s, "checkpoint_gb": size_gb,
            "resume_unet": {k: list(v) if isinstance(v, tuple) else v for k, v in SD_FT_RESUME_DEPTH.items()},
            "resumed_equals_uninterrupted": True, "launches": launches, "launches_under_autograd": under,
            "gradient_cases": check_attention_gradients(cases, "sd_finetune")}


def run_transport():
    """sliced_histogram_transport over a 1024^2 RGB image (TRANSPORT_ITERS iterations, the rotations from
    seed-made normals) and each hist_match mode, card vs CPU: the CDF remaps within one bin of the range
    and 1e-4 of it on average (a value that crosses a bin edge moves later CDF steps by 1 / N), the
    covariance modes within TRANSPORT_TOL of the largest magnitude. Seconds on each device."""
    import numpy as np
    import torch

    from maua_tpu_torch.ops import transport as TR

    rs = np.random.RandomState(18)
    n = TRANSPORT_SIZE
    src = torch.from_numpy(rs.rand(n, n, 3).astype(np.float32))
    tgt = torch.from_numpy((rs.rand(n, n, 3) ** 2 * np.array([1.0, 0.5, 2.0])).astype(np.float32))
    normals = [rs.randn(3, 3).astype(np.float32) for _ in range(TRANSPORT_ITERS)]
    out, res = {}, {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            a, b = src.to(dev), tgt.to(dev)
            t0 = time.perf_counter()
            res[dev] = {"sliced": TR.sliced_histogram_transport(a, b, TRANSPORT_ITERS, normals=normals).cpu(),
                        **{m: TR.hist_match(a, b, mode=m).cpu() for m in ("cdf", "chol", "pca", "sym")}}
            out[f"{dev}_seconds"] = time.perf_counter() - t0
    errs = {}
    for k, want in res["cpu"].items():
        got = res["cuda"][k]
        err = (got - want).abs()
        if k in ("sliced", "cdf"):
            span = float(want.max() - want.min())
            errs[k] = {"max_of_range": float(err.max()) / span, "mean_of_range": float(err.mean()) / span}
            ok = float(err.max()) <= span / 256 and float(err.mean()) <= 1e-4 * span
        else:
            errs[k] = float(err.max()) / float(want.abs().max())
            ok = errs[k] <= TRANSPORT_TOL
        if not ok or got.shape != src.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"transport {k}: card vs CPU {errs[k]}")
    return {**out, "card_vs_cpu": errs}


# ------------------------------------------------------------ frame codec, host kernels, profiling
CODEC_PSNR_BAR = 40.0  # every delivered frame against the card's own I420 of it: maua_tpu's bar
CODEC_AB_ROUTES = ("yuv420p", "dct", "dct", "yuv420p")  # the renderer's A/B: P N N P
CODEC_AB_SECONDS = 2.0  # the renderer A/B's clip: 48 frames (the checked render takes the 3 s e2e clip)
CODEC_CPU_FRAMES = 3  # of the first chunk's 8, encoded on the CPU too: intra and two deltas (the CPU's ~1 s a frame)
CODEC_TIMED = 5  # timed calls of the native decode (median); the numpy decode (~1.1 s a chunk) is timed once


@contextlib.contextmanager
def dct_route_recorded():
    """Within the block, keeps what the dct route of pipelined_frames handles: each batch it is given (a copy
    on the card), the frames it hands out and the plan it calibrated."""
    from maua_tpu_torch.ops import framecodec as FC
    from maua_tpu_torch.ops import video as V

    seen = {"batches": [], "frames": [], "codecs": []}
    route, calibrate = V.pipelined_frames, FC.calibrate_chunk_device

    def recording(batches, pix_fmt="rgb24", **kw):
        def kept():
            for item in batches:
                batch = item[0] if isinstance(item, tuple) else item
                seen["batches"].append((batch.clone(), item[1] if isinstance(item, tuple) else batch.shape[0]))
                yield item

        for f in route(kept() if pix_fmt == "dct" else batches, pix_fmt, **kw):
            if pix_fmt == "dct":
                seen["frames"].append(f)
            yield f

    def calibrating(*a, **k):
        codec = calibrate(*a, **k)
        seen["codecs"].append(codec)
        return codec

    with swapped(V, "pipelined_frames", recording), swapped(FC, "calibrate_chunk_device", calibrating):
        yield seen


def codec_stream_card_vs_cpu(batch, codec) -> dict:
    """The card's chunk stream against the CPU's encode of the same uint8 frames: equal bytes, or every
    differing quantized coefficient at a tie of the CPU's own f32 coefficient (raises otherwise)."""
    import numpy as np

    from maua_tpu_torch.ops import framecodec as FC

    card = [t.cpu().numpy() for t in FC.encode_chunk(batch, codec)]
    cpu = [t.numpy() for t in FC.encode_chunk(batch.cpu(), codec)]
    if all(np.array_equal(a, b) for a, b in zip(card, cpu)):
        return {"stream_bytes_differing": 0, "coefficients_at_ties": 0}
    ties = 0
    planes = FC._yuv_planes_device(batch.cpu())
    ci = codec.intra
    for pl, got, want, q in zip(planes, FC.chunk_coefficients(batch, codec), FC.chunk_coefficients(batch.cpu(), codec),
                                (ci.qstep_y, ci.qstep_c, ci.qstep_c)):
        diff = (got.cpu() != want).numpy()
        if diff.any():
            r = FC._block_dct_device(pl).numpy()[diff].astype(np.float64) / q
            if not np.all(np.abs(r - (np.floor(r) + 0.5)) < 1e-5):
                raise AssertionError(f"codec: the card's coefficients differ from the CPU's away from a tie: {r}")
        ties += int(diff.sum())
    return {"stream_bytes_differing": int(sum((a != b).sum() for a, b in zip(card, cpu))), "coefficients_at_ties": ties}


def run_codec(wav: str, repo: str, tmp: str):
    """The dct delivery of the e2e clip: the example StyleGAN2 patch (config-f 1024^2, seed 0, the facade's s2d
    route) over the 3 s wav through the entry point's FFMPEG renderer with pix_fmt="dct", batch 8, into a file
    (ffmpeg, or OpenCV without it) read back with OpenCV; the epilogue's launches counted. Every delivered frame
    against the card's own I420 of it (PSNR >= CODEC_PSNR_BAR); the card's stream of the first chunk's first
    CODEC_CPU_FRAMES frames against the CPU's encode of them; the native decode against the numpy decode
    (within one gray level on under 1 % of the bytes); how many plans the route calibrated (a chunk its plan
    does not hold is encoded again under one that does). Times: calibration on the card, encode a chunk (CUDA
    events), native and numpy decode a chunk (host), packed bytes a frame against I420's. Then the renderer's
    A/B, yuv420p against dct in turns (P N N P), render-stage fps over a CODEC_AB_SECONDS clip; and the
    delivery alone (the facade's render of the 72 frames, no writer) likewise."""
    import cv2
    import numpy as np
    import torch

    from maua_tpu_torch import native
    from maua_tpu_torch.audiovisual.generate import generate_audiovisual_from_patch
    from maua_tpu_torch.gan.wrappers import StyleGAN2
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.ops import framecodec as FC
    from maua_tpu_torch.ops.video import ffmpeg_available, rgb_to_yuv420

    patch = example_patch(repo, "stylegan2.py")

    ab_wav = os.path.join(tmp, "codec_ab.wav")
    synth_wav(ab_wav, seconds=CODEC_AB_SECONDS)

    def render(pix_fmt, name, clip=wav):
        stages = {}
        path, _ = generate_audiovisual_from_patch(
            clip, None, patch, renderer="ffmpeg",
            renderer_kwargs={"output_file": os.path.join(tmp, "codec", f"{name}.mp4"), "batch_size": BATCH,
                             "pix_fmt": pix_fmt},
            fps=FPS, out_size=(1024, 1024), device="cuda", stylegan_kwargs={"seed": 0}, stage_times=stages)
        torch.cuda.synchronize()
        return path, stages

    E.reset_launches()
    with epilogue_cases_recorded() as cases, dct_route_recorded() as seen:
        path, stages = render("dct", "checked")
    launches, cells = E.launches, cases["cells"].total()
    n_frames = round(SECONDS * FPS)
    batches = math.ceil(n_frames / BATCH)
    if launches != 17 * batches or cells != 4 * batches:
        raise AssertionError(f"codec: {launches} epilogue launches ({cells} on cells), want 17 x {batches} (4 on cells)")
    cap = cv2.VideoCapture(path)
    count = 0
    while cap.read()[0]:
        count += 1
    cap.release()
    if count != n_frames or len(seen["frames"]) != n_frames or not seen["codecs"]:
        raise AssertionError(f"codec: {count} frames read back, {len(seen['frames'])} delivered, "
                             f"{len(seen['codecs'])} plans; want {n_frames}, {n_frames}, >= 1")
    codec = seen["codecs"][0]
    worst, k = math.inf, 0
    for batch, n in seen["batches"]:
        ref = rgb_to_yuv420(batch).cpu().numpy()
        for t in range(n):
            worst = min(worst, psnr_db(seen["frames"][k].astype(np.float64), ref[t].astype(np.float64), 255.0))
            k += 1
    if worst < CODEC_PSNR_BAR:
        raise AssertionError(f"codec: a delivered frame reads {worst:.2f} dB against its I420 (bar {CODEC_PSNR_BAR})")
    first = seen["batches"][0][0]
    stream = codec_stream_card_vs_cpu(first[:CODEC_CPU_FRAMES], codec)

    intra, deltas = (t.cpu().numpy() for t in FC.encode_chunk(first, codec))
    via = {"native": FC.decode_chunk(intra, deltas, codec), "numpy": FC.decode_chunk(intra, deltas, codec, decoder="numpy")}
    diff = np.abs(via["native"].astype(np.int32) - via["numpy"].astype(np.int32))
    if diff.max() > 1 or (diff > 0).mean() >= 0.01:
        raise AssertionError(f"codec: native vs numpy decode {int(diff.max())} levels, {(diff > 0).mean():.4f} of bytes")

    def host_ms(fn, reps=CODEC_TIMED):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    FC.calibrate_chunk_device(first)  # warm: the phase's render calibrated once already
    calibrate_s = time.perf_counter() - t0
    out = {
        "frames": count, "writer": "ffmpeg" if ffmpeg_available() else "cv2", "launches": launches,
        "s2d_launches": cells, "stage_seconds": stages, "min_psnr_db": worst, "card_vs_cpu": stream,
        "native_vs_numpy": {"max_levels": int(diff.max()), "share_of_bytes": float((diff > 0).mean())},
        "plan": {"chroma_step": codec.chroma_step, "esc_cap_y": codec.esc_cap_y, "esc_cap_c": codec.esc_cap_c,
                 "order2_positions": [sum(codec.order2_y), sum(codec.order2_c)]},
        "plans_calibrated": len(seen["codecs"]),  # 1 + the chunks the route's plan did not hold
        "bytes_per_frame_by_plan": [c.chunk_bytes(BATCH) / BATCH for c in seen["codecs"]],
        "calibrate_seconds": calibrate_s,
        "encode_ms_per_chunk": cuda_time_ms(lambda: FC.encode_chunk(first, codec), iters=10),
        "bytes_per_frame": codec.chunk_bytes(BATCH) / BATCH, "i420_bytes_per_frame": 1024 * 1024 * 3 // 2,
        "native_decode_ms_per_chunk": host_ms(lambda: FC.decode_chunk(intra, deltas, codec)),
        "numpy_decode_ms_per_chunk": host_ms(lambda: FC.decode_chunk(intra, deltas, codec, decoder="numpy"), 1),
        "framecodec_simd_available": native.simd_available(), "decode_threads": torch.get_num_threads(),
    }
    out["bytes_ratio_i420_over_dct"] = out["i420_bytes_per_frame"] / out["bytes_per_frame"]
    del seen, first, via
    ab = {"yuv420p": [], "dct": []}
    for i, pix_fmt in enumerate(CODEC_AB_ROUTES):
        _, st = render(pix_fmt, f"ab{i}", ab_wav)
        ab[pix_fmt].append(round(CODEC_AB_SECONDS * FPS) / st["render"])
    out["renderer_fps"] = ab
    out["renderer_fps_median"] = {k: float(np.median(v)) for k, v in ab.items()}

    model = StyleGAN2(device="cuda", seed=0)
    latents = model.get_w_latents(f"0-{n_frames}")
    alone = {"yuv420p": [], "dct": []}
    for pix_fmt in CODEC_AB_ROUTES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in model.render(latents, batch_size=BATCH, pix_fmt=pix_fmt):
            pass
        alone[pix_fmt].append(n_frames / (time.perf_counter() - t0))
    del model, latents
    out["delivery_fps"] = alone
    out["delivery_fps_median"] = {k: float(np.median(v)) for k, v in alone.items()}
    out["render_seconds_dct"] = stages["render"]
    return out


NATIVE_QUANTILE_N = 10_000_000  # host samples of efficient_quantile's timing
NATIVE_DEVICE_N = 2**24 + 4097  # past torch.quantile's limit


def run_native():
    """The host kernels against their plain versions: efficient_quantile against numpy's quantile (and
    nanquantile), kthvalue against np.partition, inverse_conv against its Python loop (both masks, dilations 1
    and 2); quantile_device on the card over more than 2^24 elements against numpy; inverse_conv_device on the
    card against the host kernel; one emerging-conv round trip on the card (the forward on cuDNN, TF32 off,
    the inverse on the host kernel)."""
    import numpy as np
    import torch

    from maua_tpu_torch import native
    from maua_tpu_torch.gan import models_experimental as X

    rs = np.random.RandomState(0)
    x = rs.randn(NATIVE_QUANTILE_N).astype(np.float32)
    qs = [0.0, 0.01, 0.5, 0.99, 1.0]
    out = {"simd_available": native.simd_available()}
    t0 = time.perf_counter()
    got = native.efficient_quantile(x, qs)
    out["efficient_quantile_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = np.quantile(x, qs)
    out["numpy_quantile_ms"] = (time.perf_counter() - t0) * 1e3
    out["efficient_quantile_max_abs_err"] = float(np.abs(got - want).max())
    xn = x[:100_000].copy()
    xn[::10] = np.nan
    out["nan_max_abs_err"] = float(np.abs(native.efficient_quantile(xn, qs, ignore_nan=True) - np.nanquantile(xn, qs)).max())
    out["kthvalue_exact"] = all(native.kthvalue(x[:9973], k) == float(np.partition(x[:9973], k - 1)[k - 1])
                                for k in (1, 17, 4986, 9973))
    inv = 0.0
    for is_upper in (False, True):
        for dilation in (1, 2):
            w = X.masked_emerging_weight(torch.Generator().manual_seed(1), 4, 3, is_upper).permute(2, 3, 1, 0).numpy()
            z = rs.randn(1, 8, 8, 4).astype(np.float32)
            inv = max(inv, float(np.abs(native.inverse_conv(z, w, is_upper, dilation)
                                        - native._inverse_conv_py(z, w, is_upper, dilation)).max()))
    out["inverse_conv_vs_python_max_abs_err"] = inv
    big = torch.randn(NATIVE_DEVICE_N, generator=torch.Generator().manual_seed(2))
    card = big.cuda()
    out["quantile_device_max_abs_err"] = float(np.abs(native.quantile_device(card, qs).cpu().numpy()
                                                      - np.quantile(big.numpy(), qs)).max())
    out["quantile_device_ms"] = cuda_time_ms(lambda: native.quantile_device(card, qs), iters=5)
    with tf32_off():
        gen = torch.Generator(device="cuda").manual_seed(3)
        w = X.masked_emerging_weight(gen, 8, 3)
        xc = torch.randn(2, 8, 64, 64, generator=gen, device="cuda")
        z = X.emerging_conv(xc, w)
        back = X.emerging_conv_inverse(z, w)
        out["emerging_round_trip_max_abs_err"] = float((back - xc).abs().max())
        zs = z[:1, :, :6, :5].permute(0, 2, 3, 1).contiguous()
        wh = w.permute(2, 3, 1, 0).contiguous()
        out["inverse_conv_device_vs_host"] = float(np.abs(native.inverse_conv_device(zs, wh).cpu().numpy()
                                                          - native.inverse_conv(zs.cpu(), wh.cpu())).max())
    bars = {"efficient_quantile_max_abs_err": 1e-6, "nan_max_abs_err": 1e-6, "inverse_conv_vs_python_max_abs_err": 1e-4,
            "quantile_device_max_abs_err": 1e-5, "emerging_round_trip_max_abs_err": 1e-4,
            "inverse_conv_device_vs_host": 1e-4}
    if not out["kthvalue_exact"] or any(out[k] > v for k, v in bars.items()):
        raise AssertionError(f"native: {out} (bars {bars})")
    return out


def run_profiling(tmp: str, codec=None):
    """profiling.py on the card: one StageTimer stage around card work (its sync holds the stage until the
    work ends); a torch.profiler trace written with an annotated region; FlopCounterMode's count of one
    StyleGAN2 config-f 1024^2 frame (f32) against sg2_frame_flops; the codec render's model-FLOPs utilization
    against the card's bf16 peak, beside the card's name and power limit."""
    import torch

    from maua_tpu_torch import profiling as P
    from maua_tpu_torch.gan import stylegan2 as S2

    a = torch.randn(4096, 4096, device="cuda")
    timer = P.StageTimer()
    with timer.stage("matmuls"):
        for _ in range(20):
            a = a @ a / 64.0
        queued = torch.cuda.Event()
        queued.record()
    if not queued.query() or timer.counts["matmuls"] != 1:
        raise AssertionError("profiling: the stage ended before its card work")
    log_dir = os.path.join(tmp, "trace")
    with P.trace(log_dir):
        with P.annotate("codec_probe"):
            (a @ a).sum().item()
    trace = open(os.path.join(log_dir, "trace.json")).read()
    if "codec_probe" not in trace:
        raise AssertionError("profiling: the annotation is missing from the trace")
    cfg = S2.SG2Config(num_fp16_res=0)
    params = S2.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ws = torch.randn(1, cfg.num_ws, cfg.w_dim, device="cuda")
    with torch.no_grad():
        counted = P.compiled_flops(S2.synthesis, params, ws, cfg, noise_mode="const")
    analytic = P.sg2_frame_flops(cfg)
    n_frames = round(SECONDS * FPS)
    return {"stage_report": timer.report(), "trace_bytes": len(trace), "sg2_frame_flops": analytic,
            "flop_counter_sg2_frame": counted, "counted_over_analytic": counted / analytic,
            "codec_render_mfu_bf16_peak": (P.mfu(analytic * n_frames, codec["render_seconds_dct"], "bfloat16")
                                           if codec else "not measured (the codec phase did not run)"),
            "card": nvidia_smi()}


SERVE_CLIENTS = 6  # client threads of the GAN traffic
SERVE_GAN_REQUESTS = 24  # seeds 0..23, truncation 1.0, 0.7 and 0.5 in turn, then one z payload
SERVE_TRUNCATIONS = (1.0, 0.7, 0.5)
SERVE_SD_STEPS = 8  # euler steps of each diffusion request (cut from the serve CLI's 20 for time)
SERVE_PROMPTS = (SD_PROMPT, "a red fox in the snow")
SERVE_PSNR_BAR = 40.0  # every served or exported frame against a direct call on the same z, psi or noise: dB
EXPORT_SD_STEPS = 2  # euler steps in the exported SD program: two UNet evaluations show the loop
PIPELINE_TOL = 1e-4  # pipeline_forward's logits against forward's, f32 with TF32 off: of their largest magnitude
MOE_TOL = 1e-5  # moe_apply_ep against moe_apply, TF32 off: of the largest output magnitude
SHARDED_TOKENS = 64  # image tokens of the sharded-generation check (cut from 1024 for time)
BULK_FRAMES = 8  # 128^2 frames of the upscale_bulk_sharded check
BULK_TOL = 1e-4  # upscale_bulk_sharded against upscale one image at a time, f32 with TF32 off, images in [0, 1]:
# cuDNN picks its algorithms by batch size (23 residual blocks; 3.35e-5 in the slice's first chip call)


def _png_rgb(png: bytes):
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _frame_checks(got, want, what: str) -> dict:
    """Each served or exported uint8 frame against its direct call: PSNR (>= SERVE_PSNR_BAR) and the share
    of bit-equal pixels."""
    import numpy as np

    psnrs = [psnr_db(a, b, 255.0) for a, b in zip(got, want)]
    equal = float(np.mean([np.mean(np.asarray(a) == np.asarray(b)) for a, b in zip(got, want)]))
    if len(got) != len(want) or any(np.shape(a) != np.shape(b) for a, b in zip(got, want)) \
            or min(psnrs) < SERVE_PSNR_BAR:
        raise AssertionError(f"{what}: frames at {min(psnrs):.2f} dB against the direct calls, shapes "
                             f"{[np.shape(a) for a in got[:2]]} / {[np.shape(b) for b in want[:2]]}")
    return {"frames": len(got), "min_psnr_db": min(psnrs), "bit_equal_share": equal}


def gan_direct(gen, zs, psis, batch: int = BATCH):
    """The frames of (z, psi) rows through the facade directly, `batch` at a time (the tail padded by its
    last row, as the batcher pads): mapper, the truncation lerp, synthesizer, uint8 as maua_tpu casts."""
    import numpy as np
    import torch

    from maua_tpu_torch.serve import _find_w_avg, to_u8

    w_avg = _find_w_avg(gen.params)
    out = []
    with torch.inference_mode():
        for lo in range(0, len(zs), batch):
            z, psi = np.asarray(zs[lo : lo + batch], np.float32), np.asarray(psis[lo : lo + batch], np.float32)
            n, pad = len(z), batch - len(z)
            z, psi = np.concatenate([z, np.repeat(z[-1:], pad, 0)]), np.concatenate([psi, np.repeat(psi[-1:], pad)])
            ws = gen.mapper(torch.from_numpy(z).cuda())
            ws = w_avg + torch.from_numpy(psi).cuda()[:, None, None] * (ws - w_avg)
            out.extend(to_u8(gen.synthesizer(ws)).cpu().numpy()[:n])
    return out


def run_serve(tmp: str):
    """`serve http` on the card: make_http_server on port 0 over GANImageService (config-f 1024^2, seed-0
    weights, max_batch 8, warmed up), DiffusionImageService (SD 1.x v1-inference widths, 512^2, max_batch
    2, SERVE_SD_STEPS euler steps) and UpscaleService (RealESRGAN-x4plus); traffic over HTTP: 24 GAN
    requests from 6 client threads and one z payload, two prompts posted together (one batch), one of
    them again alone, a 128^2 upscale. Every PNG against a direct call on the same z, psi or noise; the
    epilogue's launches 17 a GAN batch and the attention kernel's 10 an evaluation and 1 a decode, from
    /healthz's batch counts; every case either kernel met held against its plain version. Then a
    StyleGAN3 GANImageService (config T 1024^2) batch: 13 filtered-lrelu launches. p50 / p95 latency in
    the batcher (submit to frame) and at the clients (the HTTP round trip with the PNG), occupancy, the
    host's PNG time."""
    import base64
    import io
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from PIL import Image

    from maua_tpu_torch import serve as SV
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.kernels import epilogue as E
    from maua_tpu_torch.kernels import filtered_lrelu as FL
    from maua_tpu_torch.text.clip_text import tokenize

    t0 = time.perf_counter()
    gan = SV.GANImageService(max_batch=BATCH, device="cuda")
    sd = SV.DiffusionImageService(max_batch=2, timesteps=SERVE_SD_STEPS, sampler="euler", device="cuda")
    up = SV.UpscaleService("RealESRGAN-x4plus", device="cuda")
    services = {"gan": gan, "diffusion": sd, "upscale": up}
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gan.warmup()
    sd.warmup()
    warmup_s = time.perf_counter() - t0
    server = SV.make_http_server(services, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(name, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/{name}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            if resp.status != 200 or resp.headers["Content-Type"] != "image/png":
                raise AssertionError(f"serve: /v1/{name} answered {resp.status} {resp.headers['Content-Type']}")
            return resp.read()

    def healthz():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            return json.loads(resp.read())

    rs = np.random.RandomState(99)
    z_row = rs.randn(gan.gen.z_dim).astype(np.float32)
    small = (np.clip(rs.rand(128, 128, 3) * 0.5 + np.linspace(0, 0.5, 128)[None, :, None], 0, 1) * 255)
    small = small.astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(small).save(buf, format="PNG")
    try:
        before = healthz()
        E.reset_launches()
        A.reset_launches()
        with epilogue_cases_recorded() as ecases, attention_cases_recorded() as acases:
            payloads = [{"seed": s, "truncation": SERVE_TRUNCATIONS[s % 3]} for s in range(SERVE_GAN_REQUESTS)]
            payloads.append({"z": z_row.tolist(), "truncation": 0.7})
            def timed_post(p):
                t = time.perf_counter()
                png = post("gan", p)
                return png, (time.perf_counter() - t) * 1e3

            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                gan_pngs, client_ms = zip(*pool.map(timed_post, payloads))
            gan_s = time.perf_counter() - t0
            with ThreadPoolExecutor(2) as pool:  # posted together: one batch of both prompts
                pair = list(pool.map(lambda i: post("diffusion", {"text": SERVE_PROMPTS[i], "seed": i + 1}), (0, 1)))
            alone = post("diffusion", {"text": SERVE_PROMPTS[0], "seed": 1})
            up_png = post("upscale", {"image": base64.b64encode(buf.getvalue()).decode()})
            torch.cuda.synchronize()
            health = healthz()
            e_launches, a_launches = E.launches, A.launches
        gan_batches = health["gan"]["batches"] - before["gan"]["batches"]
        sd_batches = health["diffusion"]["batches"] - before["diffusion"]["batches"]
        if e_launches != 17 * gan_batches:
            raise AssertionError(f"serve: {e_launches} epilogue launches for {gan_batches} GAN batches")
        if a_launches != (10 * SERVE_SD_STEPS + 1) * sd_batches or sd_batches != 2:
            raise AssertionError(f"serve: {a_launches} attention launches for {sd_batches} diffusion batches")
        if health["diffusion"]["max_occupancy"] != 2 or health["gan"]["served"] - before["gan"]["served"] != 25:
            raise AssertionError(f"serve: the two prompts did not share a batch or requests went missing: {health}")
        epilogue_rows, epilogue_err = check_epilogue_cases(ecases, "serve")
        attention_rows = check_attention_cases(acases, "serve")

        gan_frames = [_png_rgb(p) for p in gan_pngs]
        zs = [np.random.RandomState(p["seed"]).randn(gan.gen.z_dim).astype(np.float32) if "seed" in p else z_row
              for p in payloads]
        direct = gan_direct(gan.gen, zs, [p["truncation"] for p in payloads])
        t0 = time.perf_counter()
        for f in direct:
            SV._encode_png(f)
        png_ms = (time.perf_counter() - t0) / len(direct) * 1e3
        gan_check = _frame_checks(gan_frames, direct, "serve gan")

        proc = sd.proc
        with torch.inference_mode():
            sd_direct = SV.text2img_fn(proc)(tokenize(list(SERVE_PROMPTS), proc.text_cfg.context_length), [1, 2],
                                             [proc.cfg_scale] * 2).cpu().numpy()
        sd_check = _frame_checks([_png_rgb(p) for p in pair], list(sd_direct), "serve diffusion")
        alone_check = _frame_checks([_png_rgb(alone)], [_png_rgb(pair[0])], "serve diffusion alone vs co-batched")
        with torch.inference_mode():
            up_direct = (np.clip(up.upscaler(small[None].astype(np.float32) / 255.0).cpu().numpy()[0], 0, 1)
                         * 255.0).astype(np.uint8)
        up_check = _frame_checks([_png_rgb(up_png)], [up_direct], "serve upscale")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        for svc in services.values():
            svc.close()
    del gan, sd, up, services
    release_memory()

    sg3 = SV.GANImageService(architecture="stylegan3", max_batch=BATCH, device="cuda")
    try:
        sg3.warmup()
        FL.reset_launches()
        futs = [sg3.submit({"seed": s, "truncation": SERVE_TRUNCATIONS[s % 3]}) for s in range(BATCH)]
        sg3_frames = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        fl_launches, sg3_batches = FL.launches, sg3.metrics.snapshot()["batches"] - 1
        if fl_launches != 13 * sg3_batches:
            raise AssertionError(f"serve: {fl_launches} filtered-lrelu launches for {sg3_batches} StyleGAN3 batches")
        zs = [np.random.RandomState(s).randn(sg3.gen.z_dim).astype(np.float32) for s in range(BATCH)]
        sg3_check = _frame_checks(sg3_frames, gan_direct(sg3.gen, zs, [SERVE_TRUNCATIONS[s % 3] for s in range(BATCH)]),
                                  "serve stylegan3")
    finally:
        sg3.close()
    snap = health["gan"]
    return {"build_seconds": build_s, "warmup_seconds": warmup_s, "gan_traffic_seconds": gan_s,
            "gan_requests_per_s": len(payloads) / gan_s, "gan_p50_ms": snap["p50_ms"], "gan_p95_ms": snap["p95_ms"],
            "gan_client_p50_ms": float(np.percentile(client_ms, 50)),
            "gan_client_p95_ms": float(np.percentile(client_ms, 95)),
            "gan_mean_occupancy": snap["mean_occupancy"], "gan_max_occupancy": snap["max_occupancy"],
            "gan_batches": gan_batches, "epilogue_launches": e_launches, "diffusion_batches": sd_batches,
            "diffusion": health["diffusion"], "attention_launches": a_launches, "png_encode_ms_1024": png_ms,
            "gan_frames": gan_check, "diffusion_frames": sd_check, "diffusion_alone_vs_cobatched": alone_check,
            "upscale_frame": up_check, "epilogue_cases": epilogue_rows, "epilogue_max_abs_err": epilogue_err,
            "attention_cases": attention_rows,
            "attention_max_abs_err": max(r["max_abs_err"] for r in attention_rows),
            "sg3_flrelu_launches": fl_launches, "sg3_batches": sg3_batches, "sg3_frames": sg3_check}


def export_child(artifact: str, inputs: str):
    """Run in a fresh process: the generator artifact loaded by maua_tpu_torch.export alone (no model
    module), one batch replayed with the epilogue's launches counted, then ArtifactGANService over HTTP."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from maua_tpu_torch import serve as SV
    from maua_tpu_torch.kernels import epilogue as E

    t0 = time.perf_counter()
    svc = SV.ArtifactGANService(artifact)  # load_exported, the signature read from meta.json
    load_s = time.perf_counter() - t0
    data = np.load(inputs)
    with torch.inference_mode():
        svc._call(data["z"], data["psi"])  # the first call pays the kernel's load
        torch.cuda.synchronize()
        E.reset_launches()
        t0 = time.perf_counter()
        frames = svc._call(data["z"], data["psi"]).cpu().numpy()
        batch_ms = (time.perf_counter() - t0) * 1e3
    launches = E.launches
    np.save(inputs + ".frames.npy", frames)
    server = SV.make_http_server({"gan": svc}, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/v1/gan",
                                     data=json.dumps({"seed": 0, "truncation": 1.0}).encode())
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, png = resp.status, resp.read()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    models = sorted(m for m in sys.modules if m.startswith(("maua_tpu_torch.gan", "maua_tpu_torch.diffusion")))
    return {"load_seconds": load_s, "batch_ms": batch_ms, "launches": launches, "http_status": status,
            "http_psnr_db_vs_replay": psnr_db(_png_rgb(png), frames[0], 255.0), "model_modules": models}


def run_export(tmp: str):
    """export_generator at config-f 1024^2, batch 8, truncation=None (seed-0 weights): write seconds and
    size; the artifact loaded in a fresh process that imports no model module (export_child), its batch
    >= 40 dB from the live service's frames and its epilogue launches counted there; ArtifactGANService
    on it over HTTP. export_diffusion at SD 1.x widths, batch 2, EXPORT_SD_STEPS euler steps, traced and
    saved on the host while that process runs: trace and save seconds, the artifact's size (then
    deleted); the traced program run, its attention launches, its frames against text2img_fn's on the
    same noise. (process_seconds: the artifact's process from launch to its result, overlapped.)"""
    import numpy as np
    import torch

    from maua_tpu_torch import export as EX
    from maua_tpu_torch import serve as SV
    from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
    from maua_tpu_torch.gan.wrappers import StyleGAN2
    from maua_tpu_torch.kernels import attention as A
    from maua_tpu_torch.text.clip_text import tokenize

    gen = StyleGAN2(device="cuda")
    path = os.path.join(tmp, "g.pt2")
    t0 = time.perf_counter()
    EX.export_generator(gen, path, batch_size=BATCH)
    gan_write_s = time.perf_counter() - t0
    seeds = list(range(BATCH))
    psis = [SERVE_TRUNCATIONS[s % 3] for s in seeds]
    zs = np.stack([np.random.RandomState(s).randn(gen.z_dim).astype(np.float32) for s in seeds])
    live = SV.GANImageService(generator=gen, max_batch=BATCH, max_wait_ms=100.0)
    try:
        live_frames = [f.result(timeout=600) for f in [live.submit({"seed": s, "truncation": p})
                                                       for s, p in zip(seeds, psis)]]
    finally:
        live.close()
    inputs = os.path.join(tmp, "gan_inputs.npz")
    np.savez(inputs, z=zs, psi=np.asarray(psis, np.float32))
    del gen
    release_memory()
    # the artifact's process loads and replays while this one traces and saves the SD program on the host
    # (its trace touches no card; the SD program runs on the card only after that process has ended)
    t_child = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--export-child", path, inputs],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        sd = StableDiffusion(device="cuda", seed=0, timesteps=EXPORT_SD_STEPS, sampler="euler", image_size=512)
        sd_path = os.path.join(tmp, "sd.pt2")
        fn, example = EX.diffusion_program(sd, batch_size=2)  # export_diffusion's two steps, timed apart
        t0 = time.perf_counter()
        program = EX.trace(fn, example)
        sd_trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        EX.save_program(program, example, sd_path)
        sd_save_s = time.perf_counter() - t0
        sd_gb = os.path.getsize(sd_path) / 1e9
        os.remove(sd_path)
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the export process failed:\n{err[-4000:]}")
    child = {**json.loads(out.strip().splitlines()[-1]), "process_seconds": time.perf_counter() - t_child}
    if child["launches"] != 17 or child["model_modules"] or child["http_status"] != 200 \
            or child["http_psnr_db_vs_replay"] < SERVE_PSNR_BAR:
        raise AssertionError(f"export: the artifact's process read {child}")
    gan_check = _frame_checks(list(np.load(inputs + ".frames.npy")), live_frames, "export gan")
    gan_mb = os.path.getsize(path) / 1e6
    tokens = torch.from_numpy(tokenize(list(SERVE_PROMPTS), sd.text_cfg.context_length).astype(np.int64)).cuda()
    scales = torch.tensor([sd.cfg_scale] * 2, device="cuda")
    with torch.inference_mode():
        noise = SV.seeded_noise(sd, [1, 2], "cuda").permute(0, 2, 3, 1)
        A.reset_launches()
        t0 = time.perf_counter()
        got = program.module()(tokens, noise, scales).cpu().numpy()  # the written program's graph, in memory
        sd_run_s = time.perf_counter() - t0
        sd_launches = A.launches
        want = SV.text2img_fn(sd)(tokens, [1, 2], scales).cpu().numpy()
    if sd_launches != 10 * EXPORT_SD_STEPS + 1:
        raise AssertionError(f"export: the SD program launched attention {sd_launches} times")
    sd_check = _frame_checks(list(got), list(want), "export diffusion")
    del program, sd
    return {"gan_write_seconds": gan_write_s, "gan_artifact_mb": gan_mb, "gan_child": child, "gan_frames": gan_check,
            "sd_trace_seconds": sd_trace_s, "sd_save_seconds": sd_save_s, "sd_artifact_gb": sd_gb,
            "sd_run_seconds": sd_run_s, "sd_attention_launches": sd_launches, "sd_frames": sd_check}


def run_parallel():
    """The parallel layer on the card, f32 with TF32 off: pipeline_forward at ruDALL-E Malevich's widths
    (4 logical stages on the card, 4 microbatches of one sequence) against forward; sharded_generate
    against generate_tokens (SHARDED_TOKENS tokens, the same generator seed); moe_apply_ep over a 4-way
    logical expert axis (8 experts, width 1024, hidden 4096, top-2, 8192 tokens) against moe_apply;
    upscale_bulk_sharded on BULK_FRAMES frames over a 2-way logical data axis against upscale."""
    import numpy as np
    import torch

    from maua_tpu_torch.autoregressive import transformer as T
    from maua_tpu_torch.autoregressive.video import sharded_generate
    from maua_tpu_torch.parallel import moe as MOE
    from maua_tpu_torch.parallel.mesh import make_mesh
    from maua_tpu_torch.parallel.pipeline import pipeline_forward
    from maua_tpu_torch.super import image as SI

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {}
    with tf32_off(), torch.inference_mode():
        cfg, _ = autoreg_configs()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_params(cfg, gen)
        tokens = torch.randint(0, cfg.total_vocab, (4, cfg.total_length), generator=gen, device="cuda")
        ref, fwd_s = timed(lambda: T.forward(params, tokens, cfg))
        pp, pp_s = timed(lambda: pipeline_forward(params, tokens, cfg, make_mesh(axes=("stage",), devices=["cuda"] * 4),
                                                  num_microbatches=4))
        rel = float((pp - ref).abs().max() / ref.abs().max())
        del pp, ref
        if rel > PIPELINE_TOL:
            raise AssertionError(f"parallel: pipeline logits {rel:.3g} of their peak from forward's")
        out["pipeline"] = {"logits_rel_err": rel, "forward_seconds": fwd_s, "pipeline_seconds": pp_s,
                           "stages": 4, "microbatches": 4, "tokens": list(tokens.shape)}
        text = tokens[:, : cfg.text_length]
        kw = dict(top_k=AUTOREG_TOP_K, n_image_tokens=SHARDED_TOKENS)
        want, gen_s = timed(lambda: T.generate_tokens(params, text, cfg, gen=torch.Generator(device="cuda")
                                                      .manual_seed(3), **kw))
        got, sharded_s = timed(lambda: sharded_generate(params, text, cfg, make_mesh(devices=["cuda"]),
                                                        gen=torch.Generator(device="cuda").manual_seed(3), **kw))
        if not torch.equal(got, want):
            raise AssertionError(f"parallel: sharded tokens differ at {int((got != want).sum())} positions")
        out["sharded_generate"] = {"tokens": list(got.shape), "equal": True, "seconds": sharded_s,
                                   "unsharded_seconds": gen_s}
        del params, tokens
        release_memory()

        mcfg = MOE.MoEConfig(width=1024, hidden=4096, n_experts=8, top_k=2)
        mp = MOE.init_moe(mcfg, torch.Generator(device="cuda").manual_seed(1))
        x = torch.randn(8192, 1024, generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
        (dense, aux), dense_s = timed(lambda: MOE.moe_apply(mp, x, mcfg))
        (ep, ep_aux), ep_s = timed(lambda: MOE.moe_apply_ep(mp, x, mcfg, make_mesh(axes=("expert",),
                                                                                   devices=["cuda"] * 4)))
        rel = float((ep - dense).abs().max() / dense.abs().max())
        if rel > MOE_TOL or abs(float(aux) - float(ep_aux)) > 1e-6:
            raise AssertionError(f"parallel: expert-parallel MoE {rel:.3g} of the dense peak, aux {aux} / {ep_aux}")
        out["moe"] = {"rel_err": rel, "aux": float(aux), "aux_ep": float(ep_aux), "dense_seconds": dense_s,
                      "ep_seconds": ep_s, "tokens": x.shape[0], "experts": mcfg.n_experts, "expert_shards": 4}
        del mp, x, dense, ep

        up = SI.Upscaler("RealESRGAN-x4plus", device="cuda")
        rs = np.random.RandomState(5)
        frames = [rs.rand(1, 128, 128, 3).astype(np.float32) for _ in range(BULK_FRAMES)]
        with first_rungs_only("parallel"):
            want, one_s = timed(lambda: list(SI.upscale(frames, model=up)))
            got, bulk_s = timed(lambda: list(SI.upscale_bulk_sharded(frames, batch_size=3, model=up,
                                                                     mesh=make_mesh(2, devices=["cuda"] * 2))))
            # the same batches as the bulk path makes them (3 frames padded to 4 by the last), through the model
            same = [up(np.concatenate(fs + fs[-1:] * (-len(fs) % 2))).cpu().numpy()[: len(fs)]
                    for fs in (frames[i : i + 3] for i in range(0, BULK_FRAMES, 3))]
        same = [f[None] for b in same for f in b]
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        if len(got) != BULK_FRAMES or err > BULK_TOL or not all(np.array_equal(a, b) for a, b in zip(got, same)):
            raise AssertionError(f"parallel: upscale_bulk_sharded {err} from upscale over {len(got)} frames, or not "
                                 f"the model's output on its own batches")
        out["upscale_bulk_sharded"] = {"frames": BULK_FRAMES, "max_abs_err_vs_upscale": err,
                                       "equal_to_its_batches": True, "seconds": bulk_s, "upscale_seconds": one_s}
    return out


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
    if sys.argv[1:2] == ["--sg3-reference-child"] and len(sys.argv) == 3:
        sg3_reference_child(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--ss-mir-child"] and len(sys.argv) == 3:
        print(json.dumps(ss_mir_child(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--export-child"] and len(sys.argv) == 4:
        print(json.dumps(export_child(sys.argv[2], sys.argv[3])))
        return 0
    if sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3:
        phases = set(sys.argv[2].split(","))
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--phases kernel,flrelu,attn,mel,kconv,e2e,sg3_e2e,ar_e2e,ar_features,"
              "ar_reference,gan_load,sd_load,writer,super_load,super_video,umx,noise_patch,gan_generate,fast,"
              "profile,sg3_profile,reference,sg3_reference,sd_e2e,sd_steps,sd_profile,sd_reference,super,"
              "super_reference,sd_multires,sg3_resize,realtime,ss_mir,ss_e2e,ss_reference,interactive,"
              "av_correlation,sd_guided,sd_paths,sd_glide,sd_animation,sd_video,flow_neural,style,style_video,"
              "epilogue_grad,gan_langevin,style_zoo,nca,video_vit,optimizers,gan_train,gan_langevin_d,"
              "gan_train_reference,autoreg,autoreg_reference,autoreg_video,autoreg_finetune,gan_icgan,sd_finetune,"
              "transport,delivery,codec,native,profiling,serve,export,parallel,int8]",
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

        from maua_tpu_torch import native

        names = ("epilogue", "filtered_lrelu", "attention", "spectrogram", "kconv", "conv_i8")
        with ThreadPoolExecutor(len(names) + 1) as pool:  # one nvcc per source and the host g++, all started together
            host = pool.submit(native.build)
            libs = list(pool.map(build.build, names))
            host_lib = host.result()
        return {"libraries": [str(p) for p in libs], "host_library": str(host_lib),
                "ptxas": {n: build.PTXAS_REPORT.get(n, "") for n in names}}

    phase("build", build_all)
    results = {}
    for name, fn in (("kernel", check_epilogue), ("epilogue_grad", run_epilogue_grad), ("flrelu", check_flrelu),
                     ("attn", check_attention), ("mel", check_mel), ("kconv", check_kconv)):
        if want(name):
            results[name] = phase(name, fn)
            release_memory()
    sg3_reference = {}
    with tempfile.TemporaryDirectory() as ref_dir:
        try:
            with tempfile.TemporaryDirectory() as tmp:
                wav, song = os.path.join(tmp, "mix.wav"), os.path.join(tmp, "song.wav")
                synth_wav(wav)
                synth_wav(song, seconds=SONG_SECONDS, seed=1, chords=True)
                for name, fn in (("e2e", lambda: run_e2e(wav, repo)), ("sg3_e2e", lambda: run_sg3_e2e(wav, repo)),
                                 ("ar_e2e", lambda: run_ar_e2e(wav, tmp)), ("ar_features", lambda: run_ar_features(song)),
                                 ("ar_reference", lambda: ar_card_vs_cpu(song)), ("gan_load", lambda: run_gan_load(wav, repo, tmp)),
                                 ("sd_load", lambda: run_sd_load(tmp)), ("writer", lambda: run_writer(repo, tmp)),
                                 ("codec", lambda: run_codec(wav, repo, tmp)),
                                 ("super_load", lambda: run_super_load(tmp)), ("super_video", lambda: run_super_video(tmp)),
                                 ("umx", lambda: run_umx(song)), ("noise_patch", lambda: run_noise_patch(wav, repo)),
                                 ("gan_generate", lambda: run_gan_generate(tmp)), ("ss_mir", lambda: run_ss_mir(song)),
                                 ("ss_e2e", lambda: run_ss_e2e(wav, tmp)), ("ss_reference", lambda: run_ss_reference(wav)),
                                 ("interactive", lambda: run_interactive(tmp)),
                                 ("av_correlation", lambda: run_av_correlation(wav, tmp)),
                                 ("sd_guided", lambda: run_sd_guided(tmp)), ("sd_paths", lambda: run_sd_paths(tmp)),
                                 ("sd_glide", lambda: run_sd_glide(tmp)), ("sd_animation", lambda: run_sd_animation(tmp)),
                                 ("sd_video", lambda: run_sd_video(tmp)), ("flow_neural", lambda: run_flow_neural(tmp)),
                                 ("style", lambda: run_style(tmp)), ("style_video", lambda: run_style_video(tmp)),
                                 ("gan_langevin", lambda: run_gan_langevin(tmp)), ("style_zoo", lambda: run_style_zoo(tmp)),
                                 ("nca", lambda: run_nca(tmp)), ("gan_train", lambda: run_gan_train(tmp)),
                                 ("gan_langevin_d", lambda: run_gan_langevin_d(tmp))):
                    if name == "gan_load" and (want("sg3_resize") or want("int8")):  # its CPU reference from here
                        sg3_reference.update(start_sg3_reference(ref_dir))
                    if want(name):
                        results[name] = phase(name, fn)
                        release_memory()
            # the four phases that once ran before gan_train_reference when its 64^2 card step read 1.35e-3 (C11)
            # run first again, as the witness that its card half (now a fresh process) no longer depends on them
            for name, fn in (("autoreg_video", in_temp_dir(run_autoreg_video)),
                             ("autoreg_finetune", in_temp_dir(run_autoreg_finetune)),
                             ("gan_icgan", in_temp_dir(run_gan_icgan)), ("sd_finetune", in_temp_dir(run_sd_finetune)),
                             ("fast", run_fast), ("int8", lambda: run_int8(sg3_reference or start_sg3_reference(ref_dir))),
                             ("profile", profile_render_batch), ("sg3_profile", profile_sg3_render_batch),
                             ("reference", card_vs_cpu), ("sg3_reference", sg3_card_vs_cpu), ("sd_e2e", run_sd_e2e),
                             ("sd_steps", run_sd_steps), ("sd_profile", profile_sd_step), ("sd_reference", sd_card_vs_cpu),
                             ("super", run_super), ("super_reference", super_card_vs_cpu), ("sd_multires", run_sd_multires),
                             ("sg3_resize", lambda: run_sg3_resize(sg3_reference or start_sg3_reference(ref_dir))), ("realtime", run_realtime), ("video_vit", run_video_vit),
                             ("optimizers", run_optimizers), ("gan_train_reference", run_gan_train_reference),
                             ("autoreg", run_autoreg), ("autoreg_reference", run_autoreg_reference),
                             ("serve", in_temp_dir(run_serve)), ("export", in_temp_dir(run_export)),
                             ("parallel", run_parallel),
                             ("transport", run_transport), ("native", run_native),
                             ("profiling", in_temp_dir(lambda tmp: run_profiling(tmp, results.get("codec")))),
                             ("delivery", run_delivery)):
                if want(name):
                    results[name] = phase(name, fn)
                    release_memory()
        finally:
            if sg3_reference and sg3_reference["proc"].poll() is None:  # a phase failed before sg3_resize
                sg3_reference["proc"].kill()
                sg3_reference["proc"].wait()
    if phases is not None:
        return 0  # a partial run prints no record

    kernel, flrelu, attn, mel, kconv, int8 = (results[k] for k in ("kernel", "flrelu", "attn", "mel", "kconv", "int8"))
    mel_launches, mel_cases = results["ar_e2e"]["spectrogram_launches"], results["ar_e2e"]["mel_cases"]
    mel_main = mel["cases"][max(mel_cases, key=lambda c: mel_cases[c] * mel["cases"][c]["bound_ms"])]
    song_cases = results["ar_features"]["warm"]["mel_cases"]
    grad_rows = [r for rows in (results["gan_langevin"]["gradient_cases"],
                                results["style_zoo"]["stylegan_adam"]["gradient_cases"],
                                results["gan_icgan"]["gradient_cases"]) for r in rows]
    grad_errs = dict(results["epilogue_grad"]["grad_max_rel_err"])  # dtype -> the largest relative error
    for r in grad_rows:
        grad_errs[r["dtype"]] = max(grad_errs.get(r["dtype"], 0.0), *r["grad_rel_err"].values())
    ss_cases = results["ss_mir"]["song"]["warm"]["mel_cases"]
    int8_epilogue = results["int8"]["sg2"]["epilogue_cases"]
    record = {"kernels": [{
        "name": "modconv_epilogue",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/epilogue.cu",
        "replaces": "maua_tpu/kernels/epilogue.py:112",
        "launches": results["e2e"]["launches"],
        "s2d_launches": results["e2e"]["s2d_launches"],
        "loaded_launches": results["gan_load"]["sg2_ada.pkl"]["launches"],
        "noise_patch_launches": results["noise_patch"]["launches"],
        "selfsupervised_launches": results["ss_e2e"]["launches"],
        "selfsupervised_s2d_launches": results["ss_e2e"]["s2d_launches"],
        "interactive_launches": results["interactive"]["launches"],
        **{f"{k}_max_abs_err": results[p]["epilogue_max_abs_err"]
           for k, p in (("selfsupervised", "ss_e2e"), ("interactive", "interactive"))},
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["s2d_frame_batch_ms"],
        "plain_ms": kernel["s2d_frame_batch_plain_ms"],
        "bound_ms": kernel["s2d_frame_batch_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        **{f"plain_route_{k}": kernel[f"frame_batch_{k}"] for k in ("ms", "plain_ms", "bound_ms")},
        "plain_route_launches": results["e2e"]["plain_1920x1080"]["launches"],
        "dct_launches": results["codec"]["launches"],
        "dct_s2d_launches": results["codec"]["s2d_launches"],
        "stylegan_param_launches": results["style_zoo"]["stylegan_adam"]["launches"],
        "langevin_launches": results["gan_langevin"]["launches"],
        "autograd_launches": {"style_zoo": results["style_zoo"]["stylegan_adam"]["launches_under_autograd"],
                              "gan_langevin": results["gan_langevin"]["launches_under_autograd"],
                              "gan_train": results["gan_train"]["launches_under_autograd"],
                              "gan_langevin_d": results["gan_langevin_d"]["launches_under_autograd"],
                              "gan_icgan": results["gan_icgan"]["launches_under_autograd"]},
        "icgan_generate_launches": results["gan_icgan"]["generate_launches"],
        "icgan_launches_per_image": results["gan_icgan"]["launches_per_image"],
        "icgan_clip_launches": results["gan_icgan"]["icgan_clip_launches"],
        "icgan_max_abs_err": results["gan_icgan"]["epilogue_max_abs_err"],
        "train_launches": results["gan_train"]["launches"],
        "serve_launches": results["serve"]["epilogue_launches"],
        "serve_batches": results["serve"]["gan_batches"],
        "serve_max_abs_err": results["serve"]["epilogue_max_abs_err"],
        "export_launches": results["export"]["gan_child"]["launches"],
        "int8_route_launches": results["int8"]["sg2"]["launches"]["epilogue"],
        "int8_route_max_abs_err": max(r["max_abs_err"] for r in int8_epilogue if not r["int8_out"]),
        "int8_out_launches": results["int8"]["sg2"]["launches"]["int8_out"],
        **{f"int8_out_{k}": sum(r[k] * r["launches"] for r in int8_epilogue if r["int8_out"])
           for k in ("ms", "plain_ms", "bound_ms")},
        "int8_out_max_code_diff": max(r["max_abs_err"] for r in int8_epilogue if r["int8_out"]),
        "langevin_d_launches": results["gan_langevin_d"]["launches"],
        "second_order_cases": results["epilogue_grad"]["second_order_cases"],
        "second_order_max_rel_err": results["epilogue_grad"]["second_order_max_rel_err"],
        "second_order_detached_min_rel_err": results["epilogue_grad"]["detached_min_rel_err"],
        "autograd_cases": len(grad_rows) + results["epilogue_grad"]["cases"],
        "autograd_grad_max_rel_err": grad_errs,
        **{f"bwd_{route}_{k}": results["epilogue_grad"][route][k]
           for route in ("plain_route_float32", "plain_route_bfloat16") for k in ("bwd_ms", "plain_bwd_ms",
                                                                                  "bwd_bound_ms")},
        "scope": f"the 17 launches of one 1024^2 StyleGAN2 frame batch of {BATCH} on the facade's route: b4..b256 "
                 f"plain, b512 and b1024 on space-to-depth grids (4 launches a batch at 256 and 128 channels, 4 "
                 f"noise groups; s2d_launches counts them in e2e); plain_route_*: the same batch with every block "
                 f"plain; plain_route_launches: the e2e clip rendered to 1920 x 1080, which the output resize "
                 f"keeps on the plain route; dct_launches: the e2e clip through the FFMPEG renderer with "
                 f"pix_fmt=\"dct\" (codec; dct_s2d_launches on cells); loaded_launches: the e2e clip rendered from an ADA .pkl (gan_load); "
                 f"noise_patch_launches: the noise-parameterization clip; selfsupervised_launches: the "
                 f"self-supervised clip (ss_e2e, s2d route; selfsupervised_s2d_launches on cells); "
                 f"interactive_launches: the interactive 8 s render to 512^2 (plain route); "
                 f"selfsupervised_max_abs_err, interactive_max_abs_err: the kernel against its plain version at "
                 f"every case those two renders launched; stylegan_param_launches: the 512^2 stylegan-"
                 f"parameterization style transfer ({ZOO_ITERS} Adam iterations, 15 launches a decode, style_zoo); "
                 f"langevin_launches: `gan generate --sampling langevin` with CLIP at 1024^2 (gan_langevin); "
                 f"autograd_launches: those of the two under autograd (`ModconvEpilogue`: the kernel forward, a "
                 f"recomputed f32 backward); autograd_cases: every case met under autograd there and every layer "
                 f"shape of a 1024^2 batch of 8 in f32 and bf16 (epilogue_grad), each's five gradients held "
                 f"against autograd of the plain version (autograd_grad_max_rel_err, of each gradient's largest "
                 f"magnitude); bwd_plain_route_*: the backward of one such batch on the plain route, its plain "
                 f"version's autograd and its bound; train_launches: `gan train` at config-f 1024^2, batch "
                 f"{GAN_TRAIN_BATCH}, {GAN_TRAIN_STEPS} steps and its evaluation (gan_train; under autograd: the G "
                 f"steps and the path-length passes, whose double backward runs the plain ops); "
                 f"langevin_d_launches: `gan generate --sampling langevin --langevin_critic discriminator` on an ADA "
                 f".pkl with a D (gan_langevin_d); second_order_*: the double backward through the Function at the "
                 f"plain route's layer shapes in f32 and bf16 against the plain version's (epilogue_grad), and the "
                 f"smallest reading of the detached backward that the bar rejects; icgan_*: IC-GAN's StyleGAN2 "
                 f"backbone at 128^2 (gan_icgan): the launches of one `generate` of 8 images, per image, and of "
                 f"{ICGAN_CLIP_STEPS} `icgan_clip` steps (under autograd but the final images' synthesis), every "
                 f"case of the generate held with icgan_max_abs_err and every autograd case among autograd_cases; "
                 f"serve_launches: `serve http`'s GANImageService at config-f 1024^2 over {SERVE_GAN_REQUESTS + 1} "
                 f"requests in serve_batches batches (17 a batch; serve), every case held with serve_max_abs_err; "
                 f"export_launches: one batch of {BATCH} replayed from the export_generator artifact in a process "
                 f"that imports no model module (export); int8_route_launches: one batch of {BATCH} on the int8 "
                 f"s2d route (int8; 4 on cells), every case of it held against the plain version "
                 f"(int8_route_max_abs_err over the float outputs), int8_out_launches those of them with an int8 "
                 f"output; int8_out_*: those int8-out launches timed at their own cases, the codes against the "
                 f"plain version's (int8_out_max_code_diff)",
    }, {
        "name": "filtered_lrelu",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/filtered_lrelu.cu",
        "replaces": "maua_tpu/kernels/filtered_lrelu.py:361",
        "launches": results["sg3_e2e"]["launches"],
        "loaded_launches": results["gan_load"]["sg3_nvidia.pt"]["launches"],
        "serve_launches": results["serve"]["sg3_flrelu_launches"],
        "int8_route_launches": results["int8"]["sg3"]["launches"]["filtered_lrelu"],
        "int8_route_max_abs_err": max(r["max_abs_err"] for r in results["int8"]["sg3"]["filtered_lrelu_cases"]),
        "max_abs_err": flrelu["max_abs_err"],
        "ms": flrelu["frame_batch_ms"],
        "plain_ms": flrelu["frame_batch_plain_ms"],
        "bound_ms": flrelu["frame_batch_bound_ms"],
        "bound_by": flrelu["bound_by"],
        "library_ms": None,
        "scope": f"the 13 launches of one 1024^2 StyleGAN3 frame batch of {BATCH} in bf16; loaded_launches: the e2e "
                 f"clip rendered from an NVIDIA-named .pt (gan_load); serve_launches: one batch of {BATCH} of "
                 f"`serve http --architecture stylegan3` (serve); int8_route_launches: one batch of {BATCH} on "
                 f"quantize_sg3's int8 plan (int8; no affines in the call, the legacy structure), each launch's "
                 f"output on the batch's own input held against the plain version (int8_route_max_abs_err)",
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
        "guided_launches": results["sd_guided"]["launches"],
        "guided_launches_per_step": results["sd_guided"]["launches_per_step"],
        "guided_launches_under_autograd": results["sd_guided"]["launches_under_autograd"],
        "autograd_cases": sum(len(results[p]["gradient_cases"]) for p in ("sd_guided", "sd_paths", "sd_finetune")),
        "autograd_grad_max_rel_err": max(r["grad_rel_err"][g] for p in ("sd_guided", "sd_paths", "sd_finetune")
                                         for r in results[p]["gradient_cases"] for g in ("dq", "dk", "dv")),
        "guided_max_abs_err": results["sd_guided"]["attention_max_abs_err"],
        "paths_launches": {k: v["launches"] for k, v in results["sd_paths"].items()
                           if isinstance(v, dict) and "launches" in v},
        "paths_max_abs_err": results["sd_paths"]["attention_max_abs_err"],
        "glide_launches": {k: results["sd_glide"][k]["launches"] for k in ("glide", "glid3xl")},
        "animation_launches": {k: results["sd_animation"][k]["launches"]
                               for k in ("interpolate", "klmc2", "outpaint", "loop")},
        "video_launches": {k: results["sd_video"][k]["launches"] for k in ("video", "loop_direct")},
        "slice_max_abs_err": max(results[p]["attention_max_abs_err"] for p in ("sd_glide", "sd_animation", "sd_video")),
        "forward_mode_launches": results["sd_animation"]["klmc2"]["launches_in_jvp"],
        "forward_mode_cases": len(results["sd_animation"]["forward_mode_cases"]),
        "forward_mode_tangent_max_rel_err": results["sd_animation"]["tangent_max_rel_err"],
        "neural_flow_video_launches": results["flow_neural"]["launches"],
        "style_launches": results["style"]["launches"],
        "style_launches_under_autograd": results["style"]["vqgan_adam"]["launches_under_autograd"],
        "style_grad_max_rel_err": max(r["grad_rel_err"][g] for r in results["style"]["gradient_cases"]
                                      for g in ("dq", "dk", "dv")),
        "style_max_abs_err": max(results[p]["attention_max_abs_err"] for p in ("flow_neural", "style")),
        "autoreg_decode_launches": results["autoreg"]["decode_launches"],
        "autoreg_rq_launches": results["autoreg_reference"]["rq"]["launches"],
        "autoreg_max_abs_err": max([results["autoreg"]["attention_max_abs_err"]]
                                   + [r["max_abs_err"] for r in results["autoreg_reference"]["rq"]["attention_cases"]]),
        "sd_finetune_launches": results["sd_finetune"]["launches"],
        "sd_finetune_launches_under_autograd": results["sd_finetune"]["launches_under_autograd"],
        "serve_launches": results["serve"]["attention_launches"],
        "serve_max_abs_err": results["serve"]["attention_max_abs_err"],
        "export_launches": results["export"]["sd_attention_launches"],
        "scope": f"the {10 * SD_STEPS + 1} launches of one 512^2 {SD_STEPS}-step SD 1.x image in f32 (sd_e2e's "
                 f"path, CUDA cores); bf16_*: the same launches in bf16 (the sd_steps path, tensor cores); "
                 f"loaded_launches: one {SD_LOAD_STEPS}-step image from a CompVis checkpoint (sd_load); "
                 f"multires_launches: one 512^2 -> 1024^2 image in nine tiles, {MULTIRES_STEPS} LMS steps "
                 f"(sd_multires), whose every case the kernel matches with multires_max_abs_err; guided_*: one "
                 f"512^2 CLIP- and colour-guided image of {SD_GUIDED_STEPS} LMS steps (sd_guided), where the kernel "
                 f"is also reached under autograd (the route's FlashAttention Function: the kernel forward, a "
                 f"recomputed backward); autograd_cases: the cases met under autograd there and in sd_paths, each "
                 f"held (dq, dk, dv) against autograd of the plain version within {GRAD_BAR:g} of their largest "
                 f"magnitude (autograd_grad_max_rel_err); paths_launches: sd_paths' image-conditioned, guided-"
                 f"diffusion and latent-diffusion runs, whose every case the kernel matches with "
                 f"paths_max_abs_err (guided_max_abs_err: the same for sd_guided); glide_launches, "
                 f"animation_launches, video_launches: the GLIDE and GLID3XL images (sd_glide), the four "
                 f"animations (sd_animation) and the flow-warped video and loop (sd_video), whose every case the "
                 f"kernel matches with slice_max_abs_err; forward_mode_*: KLMC2's launches inside torch.func.jvp "
                 f"(the route's forward-mode rule: the kernel forward, a recomputed f32 tangent), each case's "
                 f"tangent held against torch.func.jvp of the plain version within {TANGENT_BAR:g} of its "
                 f"largest magnitude; neural_flow_video_launches: the flow-warped video on RAFT flow "
                 f"(flow_neural); style_launches: the 512^2 VQGAN style transfer ({STYLE_VQGAN_ITERS} Adam "
                 f"iterations, style), whose (1, 1, 16384, 128) decoder attention runs under autograd "
                 f"(style_launches_under_autograd; dq, dk, dv within style_grad_max_rel_err), every case of both "
                 f"matched with style_max_abs_err; autoreg_decode_launches: the VQ decode of 4 images of "
                 f"ruDALL-E's 32 x 32 tokens, (4, 1, 1024, 512) (autoreg); autoreg_rq_launches: one RQ encode at "
                 f"depths 1 and 4 and one decode of a 256^2 image (autoreg_reference), every case of both within "
                 f"autoreg_max_abs_err; sd_finetune_*: {SD_FT_STEPS} SD 1.x finetune steps at 512^2 with their "
                 f"validation sample ({SD_FT_SAMPLE_STEPS} LMS steps), 10 a step under autograd, their cases among "
                 f"autograd_cases; serve_launches: `serve http`'s DiffusionImageService at 512^2, two batches of "
                 f"{SERVE_SD_STEPS} euler steps (10 an evaluation, 1 a decode), every case held with "
                 f"serve_max_abs_err; export_launches: the export_diffusion program at SD 1.x widths, batch 2, "
                 f"{EXPORT_SD_STEPS} steps, loaded and run (export)",
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
        "ss_mir_launches": results["ss_mir"]["song"]["warm"]["mel_launches"],
        **{f"ss_mir_{k}": sum(n * mel["cases"][c][k] for c, n in ss_cases.items())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "ss_e2e_launches": results["ss_e2e"]["mel_launches"],
        "scope": f"the {mel_launches} launches of one {SECONDS:g} s mel-patch video, each priced at its mel case "
                 f"({', '.join(f'{n} x {c}' for c, n in mel_cases.items())}); song_*: the launches of the feature "
                 f"stage over a {SONG_SECONDS:g} s song (ar_features), priced alike "
                 f"({', '.join(f'{n} x {c}' for c, n in song_cases.items())}); ss_mir_*: the launches of one "
                 f"self-supervised MIR call over the song ({', '.join(f'{n} x {c}' for c, n in ss_cases.items())}); "
                 f"ss_e2e_launches: those of the self-supervised clip's MIR; library: torch.stft and the mel matmul",
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
    }, {
        "name": "conv_i8",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/conv_i8.cu",
        "replaces": "maua_tpu/gan/fast_synthesis.py:179",
        "replaces_also": "maua_tpu/gan/stylegan3.py:399",
        "launches": results["int8"]["sg2"]["launches"]["conv_i8"],
        "max_abs_err": int8["conv_i8_max_abs_err"],
        **{k: int8["conv_i8_sg2_batch"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                     "cudnn_bf16_conv_ms")},
        "staging_routes": int8["conv_i8_sg2_batch"]["routes"],
        "sg3_launches": results["int8"]["sg3"]["launches"]["conv_i8"],
        **{f"sg3_{k}": int8["conv_i8_sg3_batch"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                              "cudnn_bf16_conv_ms")},
        "sg3_staging_routes": int8["conv_i8_sg3_batch"]["routes"],
        "scope": f"not a Pallas kernel: the port's kernel for the XLA int8 convs of the W8A8 plans (PyTorch has "
                 f"no int8 convolution on CUDA). The {results['int8']['sg2']['launches']['conv_i8']} launches of "
                 f"one StyleGAN2 config-f 1024^2 batch of {BATCH} on the int8 s2d route (int8: b512 and b1024, "
                 f"conv0 and conv1 on cells); max_abs_err: the largest over those, the StyleGAN3 trunk's and the all +-127 case, against the plain version; sg3_*: "
                 f"the {results['int8']['sg3']['launches']['conv_i8']} trunk convs of one StyleGAN3 config T "
                 f"1024^2 batch of {BATCH} on quantize_sg3's plan; library: torch._int_mm over F.unfold (the "
                 f"same integer function, timed only); cudnn_bf16_conv_ms: cuDNN's bf16 F.conv2d at the same "
                 f"shapes (a different function, timed only); staging_routes: the cases by how the kernel staged x "
                 f"(tma where W % 16 == 0, else cp.async)",
    }]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the `cuda` marker and skips, from a fixture,
where there is no CUDA device. This file imports neither JAX nor
maua_tpu, so it runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: one bf16 ulp (rtol 2^-7) for bf16 storage, since kernel and
plain version compute in f32 and round once; rtol 1e-5 in f32, where
only the kernel's fused multiply-add differs. The filtered lrelu sums
some 70 products per output in another order than the plain version's
convolutions: 1e-4 absolute in f32 on outputs of magnitude ~10, and
that allowance on top of one bf16 ulp in bf16. Flash attention sums over
up to 4096 keys in another order: 1e-4 relative plus 1e-5 absolute in
f32; in bf16 one bf16 ulp plus 2^-5 of the output's RMS, since the kernel
rounds p (each within 2^-9) against its running row max and the plain
version against the final one, and those roundings average over the keys.
The kernel route under forward mode (KLMC2's jvp) is held to 1e-4 of the
largest output and tangent against torch.func.jvp of the plain version.
The mel kernel's FFT and the plain version's cuFFT round differently:
1e-4 of the largest output, the bar of the JAX package's own mel kernel
test. kconv sums 9 Ci products in another order than cuDNN's f32 conv
(TF32 off): 1e-5 relative plus 1e-5 absolute in f32, and one bf16 ulp on
top of that in bf16. Frame delivery and I420 conversion are exact: the
same bytes as the CPU and as a synchronous copy. The super-resolution
models, the lanczos resample and RIFE's midpoint run cuDNN / cuBLAS on the
card and oneDNN / BLAS on the CPU, f32 with TF32 off: 1e-3 absolute on
upscaled images in [0, 1] (up to 23 residual blocks of convolutions summed
in other orders), 1e-5 for the resample (one weighted sum per axis) and
1e-4 for the midpoint. The s2d synthesis route sums its cell convs in
other orders on the two devices (cuDNN, oneDNN; TF32 off): 1e-4 absolute
on images of magnitude ~1; the separator's LSTM and FFTs likewise, 1e-4
on stems of peak ~0.8; the realtime walk's uint8 frames within one level
of the CPU's on the same draws. A self-supervised patch's latents and
noise windows on the card against the CPU on the same draws: 1e-4
absolute (a Loop window's phase magnifies the card's and the CPU's
cos roundings up to 50-fold). The epilogue's gradient through its kernel
route (`ModconvEpilogue`) against autograd of the plain version: 1e-4 of
each gradient's largest magnitude in f32 (the same sums in other orders),
and one bf16 ulp of that magnitude on top in bf16; its second-order gradients
(create_graph) the same. A GAN train step card vs CPU: 1e-3 of each gradient
leaf's largest magnitude, floored at 1e-2 of its network's largest. The
autoregressive samplers on the card: the same tokens from the cached and
the recompute paths given the same draws, and card vs CPU logits within
1e-4 of the largest (TF32 off). The VQ decode with its mid attention on the
kernel route against the CPU's plain decode: 1e-4 absolute on images in
[-1, 1]. An SD finetune step's gradient card vs CPU (TF32 off): 1e-3 of each
leaf's largest magnitude, floored at 1e-7 of the largest of all (the conv
biases before one-channel groups have a gradient of exactly 0, computed as
f32 noise). The DCT frame codec on the card: the CPU's plan, bytes and
delivered frames exactly (its arithmetic is elementwise f32 in a fixed
order); the sort-based quantiles past 2^24 elements within 1e-5 of numpy's
(positions q * (n - 1) in f32, as jnp.quantile computes them). The kernels'
custom ops (what a torch.export graph calls) and an exported program of each,
saved and loaded, are held to their wrappers' bars at f32, one launch a call.
The int8 conv sums exactly in int32 on both sides: the kernel equals its plain
version bit for bit. The epilogue's int8 output: codes within 1 of the plain
version's (the kernel rounds each product and sum on its own, as the plain
ops do, so they are expected equal). The int8 routes (StyleGAN2's s2d tail,
StyleGAN3's trunk) on a plan carried from the CPU, card vs CPU with TF32 off:
>= 40 dB PSNR over the [-1, 1] range (an activation that lands on the other
side of a quantization step moves one code).
"""

import math

import pytest
import torch

from maua_tpu_torch.audio import spectral as S
from maua_tpu_torch.gan.stylegan3 import _lowpass
from maua_tpu_torch.kernels import attention as A
from maua_tpu_torch.kernels import conv_i8 as CI
from maua_tpu_torch.kernels import epilogue as E
from maua_tpu_torch.kernels import filtered_lrelu as FL
from maua_tpu_torch.kernels import kconv as K
from maua_tpu_torch.kernels import spectrogram as M
from maua_tpu_torch.ops import video as V


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,noise_shape,use_pre,clamp", [
    ((8, 32, 64, 64), (1, 1, 64, 64), False, 256.0),
    ((8, 32, 64, 64), (8, 1, 64, 64), True, None),
    ((2, 128, 16, 16), (2, 8, 16, 16), True, 256.0),
    ((3, 5, 7, 9), (3, 1, 7, 9), False, 256.0),  # H*W not a multiple of 8: the scalar path
    ((2, 16, 8, 8), None, False, 256.0),
    ((4, 128, 32, 32), (1, 4, 32, 32), True, 256.0),  # the s2d route's cells: 4 phase groups, shared noise
])
def test_epilogue_kernel_matches_plain(cuda_device, dtype, shape, noise_shape, use_pre, clamp):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, c = shape[:2]
    z = (torch.randn(*shape, generator=gen, device=cuda_device) * 4).to(dtype)
    post = torch.rand(b, c, generator=gen, device=cuda_device) + 0.5
    noise = None if noise_shape is None else torch.randn(*noise_shape, generator=gen, device=cuda_device)
    bias = torch.randn(c, generator=gen, device=cuda_device)
    pre = torch.rand(b, c, generator=gen, device=cuda_device) + 0.5 if use_pre else None
    E.reset_launches()
    out = E.modconv_epilogue(z, post, noise, bias, clamp=clamp, pre_next=pre)
    torch.cuda.synchronize()
    assert E.launches == 1
    ref = E.modconv_epilogue_plain(z, post, noise, bias, clamp=clamp, pre_next=pre)
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,noise_shape,use_pre,clamp", [
    ((8, 512, 16, 16), (1, 1, 16, 16), False, 256.0),  # a 1024^2 batch of 8 on the plain route: b16
    ((8, 64, 512, 512), (1, 1, 512, 512), False, 256.0),  # b512
    ((8, 32, 1024, 1024), (8, 1, 1024, 1024), False, 0.5),  # b1024, per-sample noise, a clamp that bites
    ((8, 256, 256, 256), (1, 4, 256, 256), True, 256.0),  # the s2d route's b512 cells, with pre_next
    ((8, 128, 512, 512), (1, 4, 512, 512), True, None),  # its b1024 cells
])
def test_epilogue_kernel_route_carries_the_gradient(cuda_device, dtype, shape, noise_shape, use_pre, clamp):
    """dz, dpost, dnoise, dbias and dpre_next through the kernel route under autograd against the
    plain version's autograd on the card: the ctypes launch alone writes an output with no grad_fn."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, c = shape[:2]
    leaves = {"z": (torch.randn(*shape, generator=gen, device=cuda_device) * 2).to(dtype),
              "post": torch.rand(b, c, generator=gen, device=cuda_device) + 0.5,
              "noise": torch.randn(*noise_shape, generator=gen, device=cuda_device),
              "bias": torch.randn(c, generator=gen, device=cuda_device) * 0.1,
              "pre_next": torch.rand(b, c, generator=gen, device=cuda_device) + 0.5 if use_pre else None}
    g = torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)
    grads = {}
    for route, fn in (("kernel", E.modconv_epilogue), ("plain", E.modconv_epilogue_plain)):
        ts = {k: None if v is None else v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
        E.reset_launches()
        y = fn(ts["z"], ts["post"], ts["noise"], ts["bias"], clamp=clamp, pre_next=ts["pre_next"])
        y.backward(g)
        torch.cuda.synchronize()
        if route == "kernel":
            assert E.launches == 1 and type(y.grad_fn).__name__ == "ModconvEpilogueBackward"
        grads[route] = {k: t.grad for k, t in ts.items() if t is not None}
    for k, ref in grads["plain"].items():
        got = grads["kernel"][k]
        assert got is not None and got.dtype == ref.dtype and got.shape == ref.shape, k
        scale = float(ref.float().abs().max())
        bar = 1e-4 * scale + (2.0**-8 * scale if dtype == torch.bfloat16 else 0.0)
        assert float((got.float() - ref.float()).abs().max()) <= bar, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,noise_shape,use_pre,clamp", [
    ((4, 64, 128, 128), (4, 1, 128, 128), False, 256.0),
    ((2, 128, 64, 64), (1, 4, 64, 64), True, 0.5),
])
def test_epilogue_kernel_route_carries_the_second_order_gradient(cuda_device, dtype, shape, noise_shape, use_pre,
                                                                   clamp):
    """The gradient of sum_I <dI, v_I> (the first-order gradients taken with create_graph) with respect to z,
    post, noise, bias, pre_next and the cotangent g, through the kernel forward and the Function's
    differentiable backward, against the plain version's autograd on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, c = shape[:2]
    leaves = {"z": (torch.randn(*shape, generator=gen, device=cuda_device) * 2).to(dtype),
              "post": torch.rand(b, c, generator=gen, device=cuda_device) + 0.5,
              "noise": torch.randn(*noise_shape, generator=gen, device=cuda_device),
              "bias": torch.randn(c, generator=gen, device=cuda_device) * 0.1,
              "pre_next": torch.rand(b, c, generator=gen, device=cuda_device) + 0.5 if use_pre else None,
              "g": torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)}
    v = {k: torch.randn(t.shape, generator=gen, device=cuda_device) for k, t in leaves.items() if t is not None}
    out = {}
    for route, fn in (("kernel", E.modconv_epilogue), ("plain", E.modconv_epilogue_plain)):
        ts = {k: None if t is None else t.detach().clone().requires_grad_(True) for k, t in leaves.items()}
        names = [k for k in ("z", "post", "noise", "bias", "pre_next") if ts[k] is not None]
        E.reset_launches()
        y = fn(ts["z"], ts["post"], ts["noise"], ts["bias"], clamp=clamp, pre_next=ts["pre_next"])
        first = torch.autograd.grad(y, [ts[k] for k in names], ts["g"], create_graph=True)
        total = sum((d.float() * v[k]).sum() for k, d in zip(names, first))
        second = torch.autograd.grad(total, [ts[k] for k in names + ["g"]], allow_unused=True)
        if route == "kernel":
            assert E.launches == 1 and type(y.grad_fn).__name__ == "ModconvEpilogueBackward"
        out[route] = {k: d for k, d in zip(names + ["g"], second)}
    assert any(d is not None and float(d.abs().max()) > 0 for d in out["plain"].values())
    for k, ref in out["plain"].items():
        got = out["kernel"][k]
        assert (got is None) == (ref is None), k
        if ref is not None:
            scale = float(ref.float().abs().max())
            bar = 1e-4 * scale + (2.0**-8 * scale if dtype == torch.bfloat16 else 0.0)
            assert float((got.float() - ref.float()).abs().max()) <= bar, k


@pytest.mark.cuda
def test_gan_train_step_card_matches_the_cpu(cuda_device):
    """One train step at 32^2 (R1, path length and the initial blur on) from the same state and draws on
    the card (TF32 off) and on the CPU: every D and G gradient leaf within 1e-3 of the larger of its
    largest magnitude and 1e-2 of its network's largest gradient (a scalar noise strength's gradient is a
    sum that cancels; chip_smoke's gan_train_reference reads the same at 64^2)."""
    from maua_tpu_torch.gan import discriminator as D
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.gan import training as TT
    from maua_tpu_torch.utility import to_device

    g_cfg = S2.SG2Config(img_resolution=32, channel_max=32, z_dim=64, w_dim=64, num_fp16_res=0)
    d_cfg, t_cfg = D.D2Config(img_resolution=32, channel_max=32), TT.TrainConfig(blur_init_sigma=2.0)
    assert t_cfg.beta1 == 0.0
    state = TT.init_train_state(g_cfg, d_cfg, t_cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    noises = lambda: {f"b{r}.conv{j}": torch.randn(4, 1, r, r, generator=gen)  # noqa: E731
                      for r in g_cfg.block_resolutions for j in ((1,) if r == 4 else (0, 1))}
    draws = {"z_d": [torch.randn(4, 64, generator=gen)], "noise_d": [noises()],
             "z_g": torch.randn(4, 64, generator=gen), "noise_g": noises(),
             "pl_noise": torch.randn(2, 3, 32, 32, generator=gen)}
    real = torch.tanh(torch.randn(4, 3, 32, 32, generator=gen))
    grads = {}
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda_device):
            st = {k: to_device(v, dev) if k != "step" else v for k, v in state.items()}
            new = TT.train_step(st, real.to(dev), g_cfg, d_cfg, t_cfg, draws=to_device(draws, dev))[0]
            grads[str(dev)] = {net: new[f"{net}_opt"][0]["mu"] for net in ("d", "g")}  # beta1 = 0: the gradients
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    card = grads[str(cuda_device)]
    for net in ("d", "g"):
        scale = max(float(w.abs().max()) for w in grads["cpu"][net])
        for got, want in zip(card[net], grads["cpu"][net]):
            bar = 1e-3 * max(float(want.abs().max()), 1e-2 * scale)
            assert float((got.cpu() - want).abs().max()) <= bar, net


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_autograd(cuda_device):
    """filtered_lrelu, melspectrogram and kconv3x3 raise where autograd records instead of handing
    back an output with no grad_fn; without autograd they launch as before."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 4, 36, 36, generator=gen, device=cuda_device)
    up_f, down_f = _lowpass(12, 100.0, 80.0, 1024.0), _lowpass(12, 100.0, 80.0, 1024.0)
    y = _signal((22050,), gen, cuda_device)
    xk = torch.randn(1, 16, 16, 8, generator=gen, device=cuda_device)
    wk = torch.randn(3, 3, 8, 8, generator=gen, device=cuda_device)
    calls = (lambda t: FL.filtered_lrelu(t, up_f, down_f, 2, 2), lambda t: M.melspectrogram(t, 22050),
             lambda t: K.kconv3x3(t, wk))
    for call, t, name in zip(calls, (x, y, xk), ("filtered_lrelu", "melspectrogram", "kconv3x3")):
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(t.clone().requires_grad_(True))
        with torch.no_grad():
            assert call(t.clone().requires_grad_(True)).is_cuda
        assert call(t).is_cuda
    with pytest.raises(RuntimeError, match="kconv3x3 has no backward"):
        K.kconv3x3(xk, wk.clone().requires_grad_(True))


@pytest.mark.cuda
def test_epilogue_kernel_rejects_what_it_does_not_take(cuda_device):
    z = torch.randn(2, 4, 8, 8, device=cuda_device)
    post, bias = torch.ones(2, 4, device=cuda_device), torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):
        E.modconv_epilogue(z.half(), post, None, bias)
    with pytest.raises(ValueError):
        E.modconv_epilogue(z.transpose(2, 3), post, None, bias)
    with pytest.raises(ValueError):
        E.modconv_epilogue(z, post.cpu(), None, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,up,affines", [
    ((2, 8, 36, 36), 2, ("pre_scale", "pre_add", "post_scale")),
    ((2, 8, 36, 36), 4, ("pre_scale", "pre_add", "post_scale")),
    ((1, 3, 37, 45), 4, ("pre_scale",)),  # odd, non-square: masked tile edges
    ((3, 2, 70, 33), 2, ("post_scale",)),
    ((2, 4, 64, 64), 4, ()),  # exact tiles
])
def test_filtered_lrelu_kernel_matches_plain(cuda_device, dtype, shape, up, affines):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, c = shape[:2]
    up_f = _lowpass(6 * up, 100.0, 80.0, 1024.0)
    down_f = _lowpass(12, 100.0, 80.0, 1024.0)
    x = (torch.randn(*shape, generator=gen, device=cuda_device) * 4).to(dtype)
    kw = {k: torch.rand(b, c, generator=gen, device=cuda_device) + 0.5 for k in affines}
    FL.reset_launches()
    out = FL.filtered_lrelu(x, up_f, down_f, up, 2, **kw)
    torch.cuda.synchronize()
    assert FL.launches == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # the plain version's convs in full f32
        ref = FL.filtered_lrelu_plain(x, up_f, down_f, up, 2, **kw)
    assert out.shape == ref.shape == (b, c, shape[2] * up // 2, shape[3] * up // 2) and out.dtype == dtype
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-4)


AFFINE_SETS = [(), ("pre_scale",), ("pre_add",), ("post_scale",), ("pre_scale", "pre_add"),
               ("pre_scale", "post_scale"), ("pre_add", "post_scale"), ("pre_scale", "pre_add", "post_scale")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("affines", AFFINE_SETS)
@pytest.mark.parametrize("shape,up,crop", [
    ((1, 2, 57, 65), 2, None),  # one row and one column past a 56 x 64 output tile
    ((2, 3, 29, 33), 4, None),  # 58 x 66 outputs: two rows and columns past a tile
    ((1, 3, 1, 2), 4, None),  # 1- to 3-pixel planes: every tile column and row is padding
    ((2, 2, 3, 1), 2, None),
    ((1, 65539, 1, 2), 2, None),  # more planes than the grid's z cap of 65535
    ((2, 3, 36, 36), 4, (10, 10, 52, 52)),  # StyleGAN3's centre crop at 36^2 -> 72^2
    ((1, 2, 70, 33), 2, (3, 5, 61, 27)),  # odd window origin at up 2
    ((1, 2, 60, 40), 4, (2, 0, 117, 65)),  # a window one past two tiles
])
def test_filtered_lrelu_kernel_tile_edges(cuda_device, dtype, affines, shape, up, crop):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, c = shape[:2]
    up_f = _lowpass(6 * up, 100.0, 80.0, 1024.0)
    down_f = _lowpass(12, 100.0, 80.0, 1024.0)
    x = (torch.randn(*shape, generator=gen, device=cuda_device) * 4).to(dtype)
    kw = {k: torch.rand(b, c, generator=gen, device=cuda_device) + 0.5 for k in affines}
    FL.reset_launches()
    out = FL.filtered_lrelu(x, up_f, down_f, up, 2, crop=crop, **kw)
    torch.cuda.synchronize()
    assert FL.launches == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # the plain version's convs in full f32
        ref = FL.filtered_lrelu_plain(x, up_f, down_f, up, 2, crop=crop, **kw)
    size = (crop[2], crop[3]) if crop else (shape[2] * up // 2, shape[3] * up // 2)
    assert out.shape == ref.shape == (b, c, *size) and out.dtype == dtype and out.is_contiguous()
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-4)


@pytest.mark.cuda
def test_filtered_lrelu_kernel_rejects_what_it_does_not_take(cuda_device):
    up_f, down_f = _lowpass(12, 100.0, 80.0, 1024.0), _lowpass(12, 100.0, 80.0, 1024.0)
    x = torch.randn(2, 4, 8, 8, device=cuda_device)
    with pytest.raises(TypeError):
        FL.filtered_lrelu(x.half(), up_f, down_f, 2, 2)
    with pytest.raises(ValueError):
        FL.filtered_lrelu(x.transpose(2, 3), up_f, down_f, 2, 2)
    with pytest.raises(ValueError):
        FL.filtered_lrelu(x, up_f, down_f, 2, 2, post_scale=torch.ones(2, 4))
    with pytest.raises(ValueError):
        FL.filtered_lrelu(x, up_f, down_f, 3, 2)
    with pytest.raises(ValueError):
        FL.filtered_lrelu(x, up_f, down_f, 2, 1)
    up4 = _lowpass(24, 100.0, 80.0, 1024.0)
    with pytest.raises(ValueError, match="even"):  # at up 4 a window starts on even rows and columns
        FL.filtered_lrelu(x, up4, down_f, 4, 2, crop=(1, 0, 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape_q,shape_kv", [
    ((2, 8, 1024, 80), (2, 8, 1024, 80)),  # SD 1.x 512^2: UNet self-attention, level 1
    ((2, 8, 256, 160), (2, 8, 256, 160)),  # level 2
    ((1, 1, 4096, 512), (1, 1, 4096, 512)),  # the VAE decoder's mid attention
    ((1, 3, 512, 64), (1, 3, 512, 64)),  # odd batch-heads
    ((1, 2, 256, 24), (1, 2, 768, 24)),  # Nq != Nk, D not a multiple of 16
    ((2, 2, 256, 8), (2, 2, 256, 8)),  # the smallest D
    ((1, 1, 512, 40), (1, 1, 512, 40)),  # one head: the kernel route, not the packed one
    ((1, 2, 256, 136), (1, 2, 256, 136)),  # not a multiple of 16, above 128
    ((1, 1, 256, 264), (1, 1, 512, 264)),  # not a multiple of 16, above 256: three output slices
    ((1, 2, 256, 64), (1, 2, 4096, 64)),  # few queries, many keys
    ((2, 6, 1024, 64), (2, 6, 1024, 64)),  # GLIDE's 64^2 base UNet (CFG batch 2) at 32^2
    ((2, 9, 256, 64), (2, 9, 256, 64)),  # and at 16^2
    ((1, 6, 1024, 64), (1, 6, 1024, 64)),  # GLIDE's 256^2 upsampler at 32^2
    ((1, 12, 256, 64), (1, 12, 256, 64)),  # and at 16^2
    ((2, 8, 6400, 40), (2, 8, 6400, 40)),  # SD 1.x outpainted to 640^2: UNet level 0, above the packed route's 4096
    ((1, 1, 6400, 512), (1, 1, 6400, 512)),  # and the VAE's mid attention there
])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, shape_q, shape_kv):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(*shape_q, generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn(*shape_kv, generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    _check_flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 33, 64])  # grids on both sides of the bf16 kernel's 32/64-row choice
@pytest.mark.parametrize("d", [8, 32, 40, 64, 80, 128, 136, 160, 256, 264, 512])
def test_flash_attention_kernel_head_dim_instances(cuda_device, dtype, heads, d):
    """Each boundary of the head-dim instances (D rounded up to 16: 32, 64, 80, 128, 160, 256, 512), with
    Nq != Nk and peaked scores (q x 4: the running max moves between key tiles). f32 is held to the f32
    tolerance against the exact function (float64): with scores of std 4 summed over D = 512 the f32 plain
    version's own roundoff comes near that tolerance, so kernel and plain version, each within it of the
    exact value, may differ by more."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q = (torch.randn(1, heads, 256, d, generator=gen, device=cuda_device) * 4).to(dtype)
    k, v = (torch.randn(1, heads, 512, d, generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    if dtype == torch.bfloat16:
        _check_flash_attention(q, k, v)
        return
    A.reset_launches()
    out = A.flash_attention_fused(q, k, v)
    torch.cuda.synchronize()
    assert A.launches == 1
    ref = torch.softmax(q.double() @ k.double().transpose(-1, -2) * d**-0.5, dim=-1) @ v.double()
    err = (out.double() - ref).abs()
    assert bool((err <= 1e-4 * ref.abs() + 1e-5).all()), float(err.max())


def _check_flash_attention(q, k, v):
    A.reset_launches()
    out = A.flash_attention_fused(q, k, v)
    torch.cuda.synchronize()
    assert A.launches == 1
    ref = A.flash_attention_plain(q, k, v).float()
    assert out.shape == ref.shape and out.dtype == q.dtype and out.stride() == q.stride()
    if q.dtype == torch.bfloat16:
        tol = 2.0**-7 * ref.abs() + 2.0**-5 * ref.pow(2).mean().sqrt()
    else:
        tol = 1e-4 * ref.abs() + 1e-5
    err = (out.float() - ref).abs()
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,d,q_scale", [
    (2, 1024, 8, 80, 1.0),  # SD 1.x 512^2, UNet level 1, as the UNet hands it over
    (2, 256, 8, 160, 1.0),  # level 2
    (2, 1024, 8, 80, 4.0),  # peaked scores: the running max moves between key tiles
])
def test_flash_attention_kernel_reads_the_unet_layout(cuda_device, dtype, b, n, h, d, q_scale):
    """(B, H, N, D) views of (B, N, H * D) linears, read and written in place."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(b, n, h * d, generator=gen, device=cuda_device).to(dtype).view(b, n, h, d).transpose(1, 2)
               for _ in range(3))
    _check_flash_attention((q * q_scale).to(dtype), k, v)


@pytest.mark.cuda
def test_attention_makes_a_misaligned_bf16_view_contiguous(cuda_device):
    """A bf16 row stride of 68 elements (a multiple of 4, not of 8) is not 16 bytes: the dispatcher hands
    the kernel a contiguous copy, and the result still matches."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(1, 1, 256, 68, generator=gen, device=cuda_device).to(torch.bfloat16)[..., :64]
               for _ in range(3))
    assert A.route(q.shape, k.shape) == "kernel" and A._layout(q) is None
    A.reset_launches()
    out = A.attention(q, k, v)
    torch.cuda.synchronize()
    assert A.launches == 1
    ref = A.flash_attention_plain(q, k, v).float()
    tol = 2.0**-7 * ref.abs() + 2.0**-5 * ref.pow(2).mean().sqrt()
    assert bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.randn(1, 2, 256, 64, device=cuda_device)
    with pytest.raises(TypeError):
        A.flash_attention_fused(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        A.flash_attention_fused(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)  # not contiguous
    off_route = torch.randn(1, 2, 200, 64, device=cuda_device)
    with pytest.raises(ValueError):
        A.flash_attention_fused(off_route, off_route, off_route)
    with pytest.raises(ValueError):
        A.flash_attention_fused(q[..., :60].contiguous(), q[..., :60].contiguous(), q[..., :60].contiguous())
    with pytest.raises(ValueError):
        A.flash_attention_fused(q, q.cpu(), q)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,layout", [
    ((2, 8, 1024, 80), "bnhd"),  # SD 1.x 512^2, UNet level 1 (CFG batch 2), as the UNet hands it over
    ((2, 8, 256, 160), "bnhd"),  # level 2
    ((1, 1, 4096, 512), "bhnd"),  # the VAE decoder's mid attention at 64^2 latents
    ((1, 8, 1024, 64), "bhnd"),  # guided diffusion's 256^2 UNet at 32^2
    ((1, 16, 256, 64), "bhnd"),  # and at 16^2
])
def test_kernel_route_carries_a_gradient(cuda_device, shape_q, layout):
    """The kernel route under autograd: its output has a grad_fn, the forward launches the kernel once,
    and dq, dk, dv match autograd of the plain version on the card (f32, TF32 off) within 1e-4 of
    their largest magnitude (sums over up to 4096 keys in other orders)."""
    b, h, n, d = shape_q
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def inputs():
        if layout == "bnhd":
            return [torch.randn(b, n, h * d, generator=gen, device=cuda_device).view(b, n, h, d).transpose(1, 2)
                    for _ in range(3)]
        return [torch.randn(b, h, n, d, generator=gen, device=cuda_device) for _ in range(3)]

    q, k, v = (t.requires_grad_(True) for t in inputs())
    do = torch.randn(b, h, n, d, generator=gen, device=cuda_device)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        A.reset_launches()
        out = A.attention(q, k, v)
        assert A.launches == 1 and type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, (q, k, v), do)
        ref_out = A.flash_attention_plain(q, k, v)
        want = torch.autograd.grad(ref_out, (q, k, v), do)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    assert (out - ref_out).abs().max() <= 1e-4 * ref_out.abs().max()
    for g, w in zip(got, want):
        assert g.shape == w.shape and float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    with torch.no_grad():
        assert A.attention(q, k, v).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,layout", [
    ((2, 8, 1024, 80), "bnhd"),  # SD 1.x 512^2, UNet level 1 (CFG batch 2): KLMC2's jvp through the UNet
    ((2, 8, 256, 160), "bnhd"),  # level 2
    ((1, 1, 4096, 512), "bhnd"),  # the VAE decoder's mid attention
])
def test_kernel_route_forward_mode(cuda_device, shape_q, layout):
    """The kernel route under torch.func.jvp (KLMC2's Hessian-vector products): the forward launches the
    kernel once, and the output and its tangent match torch.func.jvp of the plain version on the card (f32,
    TF32 off) within 1e-4 of their largest magnitude. torch.autograd.forward_ad reaches the same rule."""
    b, h, n, d = shape_q
    gen = torch.Generator(device=cuda_device).manual_seed(5)

    def inputs():
        if layout == "bnhd":
            return [torch.randn(b, n, h * d, generator=gen, device=cuda_device).view(b, n, h, d).transpose(1, 2)
                    for _ in range(3)]
        return [torch.randn(b, h, n, d, generator=gen, device=cuda_device) for _ in range(3)]

    primals, tangents = tuple(inputs()), tuple(inputs())
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        A.reset_launches()
        out, tangent = torch.func.jvp(A.attention, primals, tangents)
        torch.cuda.synchronize()
        assert A.launches == 1
        ref_out, ref_tangent = torch.func.jvp(A.flash_attention_plain, primals, tangents)
        with torch.autograd.forward_ad.dual_level():
            dual = torch.autograd.forward_ad.make_dual(primals[0], tangents[0])
            only_q = torch.autograd.forward_ad.unpack_dual(A.attention(dual, *primals[1:])).tangent
        _, ref_q = torch.func.jvp(lambda q: A.flash_attention_plain(q, *primals[1:]), primals[:1], tangents[:1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    assert A.launches == 2
    for got, want in ((out, ref_out), (tangent, ref_tangent), (only_q, ref_q)):
        assert got.shape == want.shape and float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _signal(shape, gen, device):
    """Noise plus a 440 Hz tone at 22050 Hz, so every band has energy."""
    t = torch.arange(shape[-1], device=device) / 22050.0
    return 0.3 * torch.sin(2 * torch.pi * 440.0 * t) + 0.1 * torch.randn(*shape, generator=gen, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_fft,hop,n_mels,power", [
    ((66150,), 2048, 512, 128, 2.0),  # 3 s at the onset-strength / mfcc shape
    ((66150,), 2048, 1024, 512, 2.0),  # 3 s at the spectral_max shape
    ((66150,), 2048, 1024, 128, 2.0),  # 3 s at the self-supervised MIR's shape (onsets, mfcc, tempo)
    ((3969000,), 2048, 1024, 128, 2.0),  # 180 s at that shape
    ((4, 22050), 2048, 512, 128, 1.0),  # a batch of 4, power 1
    ((2, 3, 5000), 1024, 256, 64, 2.0),  # two leading axes, another FFT size
    ((1025,), 2048, 512, 128, 2.0),  # shorter than n_fft: reflected more than once
    ((300,), 256, 100, 32, 0.5),  # the smallest FFT, a hop that does not divide it
    ((8192,), 4096, 512, 128, 2.0),  # the largest FFT
])
def test_melspectrogram_kernel_matches_plain(cuda_device, shape, n_fft, hop, n_mels, power):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    y = _signal(shape, gen, cuda_device)
    M.reset_launches()
    out = M.melspectrogram(y, 22050, n_fft=n_fft, hop_length=hop, n_mels=n_mels, power=power)
    torch.cuda.synchronize()
    assert M.launches == 1
    basis = torch.from_numpy(M.mel_basis(22050.0, n_fft, n_mels, 0.0, None)).to(cuda_device)
    ref = M.melspectrogram_plain(y, basis, n_fft, hop, power)
    assert out.shape == ref.shape == (*shape[:-1], n_mels, shape[-1] // hop) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_fft,hop,n_mels,power,offset", [
    ((3, 6000), 256, 128, 40, 2.0, 0),  # 46 frames a signal: 16 a block at n_fft 256, the last tile ragged
    ((2, 4096), 256, 128, 32, 1.0, 0),  # 32 frames a signal: tiles end where each signal ends
    ((5000,), 512, 128, 512, 2.0, 0),  # 39 frames (8 a block); 512 mels over 257 bins: empty bands
    ((2, 4096), 512, 64, 64, 0.5, 0),  # 64 frames a signal: tiles end where each signal ends
    ((2, 3, 3001), 1024, 300, 64, 2.0, 0),  # 10 frames a signal, 8 a block; a hop that does not divide n_fft
    ((4, 8192), 2048, 512, 128, 2.0, 0),  # 16 frames a signal, 4 a block: tiles end where each signal ends
    ((2, 9000), 2048, 333, 512, 1.0, 1),  # an odd float offset: the interior frames' scalar loads
    ((700,), 2048, 64, 128, 0.5, 0),  # shorter than n_fft / 2: reflected several times
    ((3, 20000), 4096, 1000, 256, 2.0, 0),  # 20 frames a signal, 4 a block
    ((2000,), 4096, 256, 128, 1.0, 0),  # shorter than n_fft
])
def test_melspectrogram_kernel_edges(cuda_device, shape, n_fft, hop, n_mels, power, offset):
    """Every n_fft instance of the warp-FFT kernel at its edges: frame counts that are and are not a
    multiple of a block's frames, signals shorter than n_fft, empty mel bands, each power, unaligned starts."""
    gen = torch.Generator(device=cuda_device).manual_seed(n_fft + hop)
    y = _signal(shape, gen, cuda_device)
    if offset:
        buf = torch.empty(y.numel() + offset, device=cuda_device)
        buf[offset:] = y.reshape(-1)
        y = buf[offset:].view(shape)
    basis = torch.from_numpy(M.mel_basis(22050.0, n_fft, n_mels, 0.0, None)).to(cuda_device)
    if n_mels == 512 and n_fft == 512:
        assert bool((basis.abs().sum(1) == 0).any())  # the case has empty bands
    M.reset_launches()
    out = M.melspectrogram(y, 22050, n_fft=n_fft, hop_length=hop, n_mels=n_mels, power=power)
    torch.cuda.synchronize()
    assert M.launches == 1
    ref = M.melspectrogram_plain(y, basis, n_fft, hop, power)
    assert out.shape == ref.shape == (*shape[:-1], n_mels, shape[-1] // hop)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_melspectrogram_kernel_rejects_what_it_does_not_take(cuda_device):
    y = torch.randn(2, 4096, device=cuda_device)
    with pytest.raises(TypeError):
        M.melspectrogram(y.double(), 22050)
    with pytest.raises(ValueError):
        M.melspectrogram(y.t().contiguous().t(), 22050)  # not contiguous
    for n_fft in (128, 1000, 8192):
        with pytest.raises(ValueError):
            M.melspectrogram(y, 22050, n_fft=n_fft)
    M.reset_launches()
    assert M.melspectrogram(y[:, :100].contiguous(), 22050, hop_length=512).shape == (2, 128, 0) and M.launches == 0


@pytest.mark.cuda
def test_spectral_melspectrogram_hands_its_signal_to_the_kernel(cuda_device):
    """The public caller neither casts nor copies: what the kernel does not take raises there too."""
    y = torch.randn(2, 4096, device=cuda_device)
    with pytest.raises(TypeError):
        S.melspectrogram(y.double(), 22050)
    with pytest.raises(TypeError):
        S.melspectrogram(y.half(), 22050)
    with pytest.raises(ValueError):
        S.melspectrogram(y.t().contiguous().t(), 22050)  # not contiguous
    with pytest.raises(ValueError):
        S.melspectrogram(y[:, ::2], 22050)  # strided
    with pytest.raises(ValueError):
        S.mfcc(y.t().contiguous().t(), 22050)
    M.reset_launches()
    out = S.melspectrogram(y, 22050, hop_length=512)
    assert M.launches == 1 and out.shape == (2, 128, 8) and out.device == y.device


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ci,co,epilogue", [
    (2, 16, 20, 5, 3, False),  # unpadded channels, partial tiles
    (1, 13, 130, 32, 32, True),  # one 32-channel block
    (2, 24, 33, 51, 51, True),  # SG3 tail channel counts, two channel blocks
    (1, 9, 61, 81, 51, False),
    (3, 37, 45, 17, 9, True),  # odd everything
    (1, 31, 31, 64, 70, True),  # three channel blocks of 32
])
def test_kconv_kernel_matches_plain(cuda_device, dtype, b, h, w, ci, co, epilogue):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(b, h, w, ci, generator=gen, device=cuda_device).to(dtype)
    wt = torch.randn(3, 3, ci, co, generator=gen, device=cuda_device) * 0.1
    kw = {}
    if epilogue:
        kw = dict(bias=torch.randn(co, generator=gen, device=cuda_device),
                  style=torch.rand(b, ci, generator=gen, device=cuda_device) + 0.5,
                  demod=torch.rand(b, co, generator=gen, device=cuda_device) + 0.5, alpha=0.2, gain=2**0.5)
    K.reset_launches()
    out = K.kconv3x3(x, wt, **kw)
    torch.cuda.synchronize()
    assert K.launches == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = K.kconv3x3_plain(x, wt, **kw)
    assert out.shape == ref.shape == (b, h, w, co) and out.dtype == dtype
    rtol = 2.0**-7 + 1e-5 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-5)


_KCONV_EPILOGUES = {
    "none": {},
    "bias": {"bias": True},
    "lrelu": {"bias": True, "alpha": 0.2},
    "style": {"style": True, "alpha": 0.2},
    "demod": {"demod": True, "bias": True},
    "modulated": {"style": True, "demod": True, "bias": True, "alpha": 0.2},
}


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", list(_KCONV_EPILOGUES))
@pytest.mark.parametrize("ci", [5, 51, 81, 192])
@pytest.mark.parametrize("co", [3, 33, 51, 65])
def test_kconv_f32_kernel_tile_edges(cuda_device, ci, co, epilogue):
    """The f32 kernel's edges: output tiles of 32 and 64 channels with ragged ends (Co 3, 33, 51, 65),
    ragged input chunks of 8, a width not a multiple of 32 and a height not a multiple of 8, two images,
    every epilogue kind with and without style and demod."""
    gen = torch.Generator(device=cuda_device).manual_seed(ci * 100 + co)
    b, h, w = 2, 19, 37
    x = torch.randn(b, h, w, ci, generator=gen, device=cuda_device)
    wt = torch.randn(3, 3, ci, co, generator=gen, device=cuda_device) / (9 * ci) ** 0.5
    kind = _KCONV_EPILOGUES[epilogue]
    kw = {}
    if kind.get("bias"):
        kw["bias"] = torch.randn(co, generator=gen, device=cuda_device)
    if kind.get("style"):
        kw["style"] = torch.rand(b, ci, generator=gen, device=cuda_device) + 0.5
    if kind.get("demod"):
        kw["demod"] = torch.rand(b, co, generator=gen, device=cuda_device) + 0.5
    if "alpha" in kind:
        kw.update(alpha=kind["alpha"], gain=2**0.5)
    K.reset_launches()
    out = K.kconv3x3(x, wt, **kw)
    torch.cuda.synchronize()
    assert K.launches == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = K.kconv3x3_plain(x, wt, **kw)
    assert out.shape == ref.shape == (b, h, w, co) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ci", [5, 17, 81])
@pytest.mark.parametrize("co", [3, 9, 51, 72])
def test_kconv_bf16_kernel_tile_edges(cuda_device, ci, co):
    """The tensor-core kernel's edges: ragged input chunks of 16 and output tiles of 64, a width not a
    multiple of 16, a height not a multiple of 16 (a block's rows), three images, a style without demod."""
    gen = torch.Generator(device=cuda_device).manual_seed(ci * 100 + co)
    b, h, w = 3, 19, 37
    x = torch.randn(b, h, w, ci, generator=gen, device=cuda_device).to(torch.bfloat16)
    wt = torch.randn(3, 3, ci, co, generator=gen, device=cuda_device) * 0.1
    kw = dict(style=torch.rand(b, ci, generator=gen, device=cuda_device) + 0.5,
              bias=torch.randn(co, generator=gen, device=cuda_device))
    _check_kconv_bf16(x, wt, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co,style,offset", [
    (2, 150, 250, 32, 64, True, 0),  # 16-byte copies, style in place
    (2, 150, 250, 81, 51, True, 0),  # scalar loads
    (2, 150, 250, 48, 40, False, 0),  # 16-byte copies, no style
    (1, 21, 45, 32, 24, True, 1),  # Ci % 8 == 0 but x not 16-byte aligned: scalar loads
    (1, 9, 16, 24, 130, False, 0),  # Ci = 24: a chunk half past Ci, zero-filled; three output tiles
])
def test_kconv_bf16_kernel_load_paths(cuda_device, b, h, w, ci, co, style, offset):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    n = b * h * w * ci
    x = torch.randn(n + offset, generator=gen, device=cuda_device).to(torch.bfloat16)[offset:].view(b, h, w, ci)
    wt = torch.randn(3, 3, ci, co, generator=gen, device=cuda_device) * 0.1
    kw = dict(demod=torch.rand(b, co, generator=gen, device=cuda_device) + 0.5, alpha=0.2)
    if style:
        kw["style"] = torch.rand(b, ci, generator=gen, device=cuda_device) + 0.5
    _check_kconv_bf16(x, wt, kw)


def _check_kconv_bf16(x, wt, kw):
    K.reset_launches()
    out = K.kconv3x3(x, wt, **kw)
    torch.cuda.synchronize()
    assert K.launches == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref = K.kconv3x3_plain(x, wt, **kw)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7 + 1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kconv_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.randn(1, 8, 8, 4, device=cuda_device)
    w = torch.randn(3, 3, 4, 6, device=cuda_device)
    with pytest.raises(TypeError):
        K.kconv3x3(x.half(), w)
    with pytest.raises(ValueError):
        K.kconv3x3(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), w)  # NCHW memory
    with pytest.raises(ValueError):
        K.kconv3x3(x, w.cpu())
    with pytest.raises(ValueError):
        K.kconv3x3(x, torch.randn(1, 1, 4, 6, device=cuda_device))
    with pytest.raises(ValueError):
        K.kconv3x3(x, w, bias=torch.zeros(5, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 96, 3), (3, 2, 2, 3)])
def test_rgb_to_yuv420_on_the_card_equals_the_cpu(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rgb = torch.randint(0, 256, shape, generator=gen, device=cuda_device, dtype=torch.uint8)
    out = V.rgb_to_yuv420(rgb)
    assert out.is_cuda and out.dtype == torch.uint8
    assert torch.equal(out.cpu(), V.rgb_to_yuv420(rgb.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("pix_fmt", ["rgb24", "yuv420p"])
def test_pipelined_frames_on_the_card_equal_the_synchronous_copy(cuda_device, pix_fmt):
    """Seven card batches (buffers reused past the pipeline's depth), a
    padded tail and a batch of another size: the frames of a synchronous
    copy of each batch, in order, byte for byte, each a copy of its own."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    shapes = [(4, 32, 48, 3)] * 6 + [(2, 32, 48, 3)]
    valid = [4, 4, 4, 4, 4, 3, 2]

    def batches():
        for shape, n in zip(shapes, valid):
            # work queued behind each batch on the compute stream, as synthesis queues it
            yield torch.randint(0, 256, shape, generator=gen, device=cuda_device, dtype=torch.uint8) * 1, n

    got = list(V.pipelined_frames(batches(), pix_fmt))
    gen.manual_seed(6)
    want = []
    for batch, n in batches():
        want.extend((V.rgb_to_yuv420(batch) if pix_fmt == "yuv420p" else batch)[:n].cpu().numpy())
    assert len(got) == sum(valid)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and (g == w).all()
    assert len({g.__array_interface__["data"][0] for g in got}) == len(got)


@pytest.mark.cuda
def test_loaded_checkpoints_land_on_the_card_and_render(cuda_device, tmp_path):
    """A StyleGAN2 ADA .pkl and a StyleGAN3 .pt (written as chip_smoke
    writes them) load onto the card through the facades and render the
    frames of the CPU facades on the same files: f32 with TF32 off, PSNR
    >= 40 dB (kernels against plain versions)."""
    import numpy as np

    import chip_smoke
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.gan import stylegan3 as S3
    from maua_tpu_torch.gan import wrappers as W

    cfg2 = S2.SG2Config(img_resolution=64, channel_base=2048, channel_max=64, z_dim=64, w_dim=64, mapping_layers=2)
    pkl = str(tmp_path / "g.pkl")
    chip_smoke.write_ada_pkl(pkl, chip_smoke.ada_state_dict(S2.init_params(cfg2, torch.Generator().manual_seed(0))))
    cfg3 = S3.SG3Config(z_dim=32, w_dim=32, img_resolution=64, channel_base=1024, channel_max=64, num_layers=6,
                        mapping_layers=2, margin_size=4)
    pt = str(tmp_path / "g3.pt")
    torch.save(chip_smoke.sg3_source_params(cfg3, device="cpu")[1], pt)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for make, launches in ((lambda d: W.StyleGAN2(model_file=pkl, dtype="float32", device=d), E),
                               (lambda d: S3.StyleGAN3(model_file=pt, device=d), FL)):
            card, cpu = make(cuda_device), make("cpu")
            assert all(t.is_cuda for t in chip_smoke._leaves(card.params))
            ws = cpu.mapper(cpu.get_z_latents("0-5"))
            launches.reset_launches()
            frames = np.stack(list(card.render(ws.to(cuda_device), batch_size=2)))
            assert launches.launches > 0
            ref = np.stack(list(cpu.render(ws, batch_size=2)))
            assert frames.shape == ref.shape == (5, 64, 64, 3) and frames.dtype == np.uint8
            mse = float(np.mean((frames.astype(np.float64) - ref) ** 2))
            assert 10 * np.log10(255.0**2 / max(mse, 1e-12)) >= 40.0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture
def no_tf32():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [
    ("RealESRGAN-x4plus", (24, 20)), ("RealESRGAN-xsx4-animevideo", (24, 20)),
    ("SwinIR-M-DFO-GAN", (19, 23)),  # padded to the window multiple
    ("waifu2x-anime-noise0", (24, 20)), ("CARN", (24, 20)),
])
def test_upscaler_on_the_card_matches_the_cpu(cuda_device, no_tf32, name, size):
    from maua_tpu_torch.super import image as SI

    card = SI.Upscaler(name, device=cuda_device, seed=0)
    host = SI.Upscaler(name, device="cpu", params=_to_cpu(card.params))
    img = torch.rand((2, *size, 3), generator=torch.Generator().manual_seed(1))
    out = card(img)
    assert out.is_cuda and out.shape == (2, size[0] * card.scale, size[1] * card.scale, 3)
    assert float((out.cpu() - host(img)).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_resample_and_rife_midpoint_on_the_card_match_the_cpu(cuda_device, no_tf32):
    from maua_tpu_torch.ops.image import resample
    from maua_tpu_torch.super import rife

    img = torch.rand((1, 300, 410, 3), generator=torch.Generator().manual_seed(2))
    for size in ((1024, 1400), (150, 97), 256):
        card = resample(img.to(cuda_device), size)
        assert float((card.cpu() - resample(img, size)).abs().max()) <= 1e-5
    params = rife.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    f0, f1 = torch.rand((2, 1, 3, 64, 96), generator=torch.Generator().manual_seed(3))
    card = rife.midpoint(params, f0.to(cuda_device), f1.to(cuda_device))
    host = rife.midpoint(_to_cpu(params), f0, f1)
    assert float((card.cpu() - host).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_s2d_route_on_the_card_matches_the_cpu(cuda_device, no_tf32):
    from maua_tpu_torch.gan import fast_synthesis as FS
    from maua_tpu_torch.gan import stylegan2 as S2

    cfg = S2.SG2Config(img_resolution=32, channel_base=1024, channel_max=64, z_dim=32, w_dim=32, mapping_layers=2)
    params = S2.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    plan = FS.build_fast_plan(params, cfg, min_channels=9999)
    ws = torch.randn(2, cfg.num_ws, cfg.w_dim, generator=torch.Generator().manual_seed(1))
    noises = {"b16.conv0": torch.randn(2, 16, 16, generator=torch.Generator().manual_seed(2))}
    E.reset_launches()
    card = FS.synthesis_fast(params, FS.device_plan(plan, cfg, cuda_device), ws.to(cuda_device), cfg,
                             noise_mode="const", noises={k: v.to(cuda_device) for k, v in noises.items()})
    assert E.launches == 1 + 2 * 3  # b4 plain, then b8..b32 on cells
    host = FS.synthesis_fast(_to_cpu(params), FS.device_plan(plan, cfg, "cpu"), ws, cfg, noise_mode="const",
                             noises=noises)
    assert float((card.cpu() - host).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_separation_on_the_card_matches_the_cpu(cuda_device, no_tf32):
    from maua_tpu_torch.audio import separate as U

    cfg = U.UMXConfig(n_fft=512, hop_length=128, hidden=32, lstm_layers=2, max_bin=100, niter=2)
    params = U.init_params(cfg, seed=3, device=cuda_device)
    t = torch.arange(16000) / 16000
    y = 0.5 * torch.sin(2 * torch.pi * 440 * t) + 0.3 * torch.sin(2 * torch.pi * 110 * t)
    card = U.separate(y.to(cuda_device), 16000, params=params, cfg=cfg)
    host = U.separate(y, 16000, params=_to_cpu(params), cfg=cfg)
    for a, b in zip(card, host):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_realtime_walk_on_the_card_replays(cuda_device, no_tf32):
    """The walk on the card against the walk on the CPU, on the same draws
    (the CPU walk is held to maua_tpu's by tests/test_torch_av_extras.py)."""
    from maua_tpu_torch.audiovisual.realtime import RealtimeModule
    from maua_tpu_torch.gan import stylegan2 as S2

    cfg = S2.SG2Config(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2)
    params = S2.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    frames = {}
    for device, tree in ((cuda_device, params), (torch.device("cpu"), _to_cpu(params))):
        gen = torch.Generator().manual_seed(5)

        def draw(shape, gen=gen, device=device):
            return torch.randn(shape, generator=gen).to(device)

        module = RealtimeModule(lambda w, tree=tree: S2.synthesis(tree, w, cfg), cfg.num_ws, cfg.w_dim, draw=draw)
        frames[device.type] = [module.frame() for _ in range(4)]
    for card, host in zip(frames["cuda"], frames["cpu"]):
        assert card.shape == (32, 32, 3) and abs(card.astype(int) - host).max() <= 1


@pytest.mark.cuda
def test_selfsupervised_patch_on_the_card_matches_the_cpu(cuda_device, no_tf32, monkeypatch):
    """One Patch realization (latents, every window of a 1024^2 net's 17
    noise layers) on the card and on the CPU, the draws made on the CPU."""
    import numpy as np

    from maua_tpu_torch.audiovisual.selfsupervised import features as F
    from maua_tpu_torch.audiovisual.selfsupervised import patch as P

    class HostDraws(P.Draws):
        def __init__(self, seed, device):
            super().__init__(seed, "cpu")
            self.target = device

        def permutation(self, path, n):
            return super().permutation(path, n).to(self.target)

        def normal(self, path, shape):
            return super().normal(path, shape).to(self.target)

    monkeypatch.setattr(P.Patch, "draws", lambda self, device: HostDraws(self.seed, device))
    gen = torch.Generator().manual_seed(0)
    t = 24
    dims = {"chromagram": 12, "tonnetz": 6, "mfcc": 20, "spectral_contrast": 7}
    feats = {k: torch.rand(t, dims.get(k, 1), generator=gen) for k in F.ALLFEATS}
    segs = {(k, n): np.arange(t) * n // t for k in F.ALLFEATS for n in (2, 4)}
    palette = torch.randn(16, 18, 64, generator=gen)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        patch = P.Patch({k: v.to(device) for k, v in feats.items()}, segs, 128.0, seed=11)
        lat, noise = patch(palette.to(device), noise_sizes=P.NOISE_SIZES[:13])  # up to 256^2
        out[device.type] = [lat] + [m(i, 8) for m in noise for i in (0, 16)]
    assert out["cuda"][0].is_cuda and len(out["cuda"]) == 1 + 2 * 13
    for card, host in zip(out["cuda"], out["cpu"]):
        assert float((card.cpu() - host).abs().max()) <= 1e-4


def _ar_cfg(**kw):
    from maua_tpu_torch.autoregressive.transformer import ARConfig

    return ARConfig(**{**dict(vocab_size=512, text_vocab_size=256, text_length=8, image_rows=8, image_cols=8,
                              width=64, layers=2, heads=4, max_frames=5), **kw})


@pytest.mark.cuda
def test_ar_samplers_agree_on_the_card(cuda_device):
    """generate_tokens (KV-cached and recompute, with forced positions) and a video fill with a guider on
    the card: the same tokens from both paths on the same draws; the card's logits against the CPU's."""
    from maua_tpu_torch.autoregressive import transformer as AT
    from maua_tpu_torch.autoregressive import video as AV
    from maua_tpu_torch.utility import to_device

    cfg = _ar_cfg()
    params = AT.init_params(cfg, torch.Generator().manual_seed(0))
    card = to_device(params, cuda_device)
    text = torch.randint(0, cfg.text_vocab_size, (3, cfg.text_length), generator=torch.Generator().manual_seed(1))
    gumbels = AT.gumbel_draws(torch.Generator().manual_seed(2))
    steps = [gumbels((3, cfg.vocab_size)).to(cuda_device) for _ in range(cfg.image_length)]
    mask = torch.arange(cfg.image_length) % 5 == 0
    forced = torch.randint(0, cfg.vocab_size, (3, cfg.image_length), generator=torch.Generator().manual_seed(3))
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        toks = [AT.generate_tokens(card, text, cfg, top_k=32, cached=c, forced_tokens=forced, forced_mask=mask,
                                   draw=lambda shape, it=iter(steps): next(it)) for c in (True, False)]
        assert torch.equal(toks[0], toks[1]) and torch.equal(toks[0][:, mask].cpu(), forced[:, mask])
        full = torch.cat([text, toks[0].cpu() + cfg.text_vocab_size], 1)
        want = AT.forward(params, full, cfg)
        got = AT.forward(card, full.to(cuda_device), cfg).cpu()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
        seq, fids, boi = AV.build_video_sequence(cfg, text[:2].numpy(), 2)
        gseq = seq.copy()
        gseq[:, : cfg.text_length] = 0
        fills = [AV.filling_sequence(card, seq, fids, boi, cfg, guider_seq=gseq, guidance_alpha=1.5, top_k=16,
                                     top_k_first_frame=4, cached=c,
                                     gen=torch.Generator(device=cuda_device).manual_seed(4))
                 for c in (True, False)]
        assert torch.equal(fills[0], fills[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@pytest.mark.cuda
def test_vq_decode_takes_the_kernel_route(cuda_device):
    """A 16 x 16 token grid at 64 mid channels: the decoder's (B, 1, 256, 64) mid attention launches the
    kernel once per decode; the decode matches the CPU's (plain attention)."""
    from maua_tpu_torch.autoregressive import vq as VQ
    from maua_tpu_torch.utility import to_device

    cfg = VQ.VQConfig(codebook_size=128, z_channels=4, base_channels=32, channel_mult=(1, 2), num_res_blocks=1)
    params = VQ.init_params(cfg, torch.Generator().manual_seed(5))
    toks = torch.randint(0, 128, (2, 256), generator=torch.Generator().manual_seed(6))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        A.reset_launches()
        got = VQ.decode_tokens(to_device(params, cuda_device), toks.to(cuda_device), cfg, 16, 16).cpu()
        assert A.launches == 1
        want = VQ.decode_tokens(params, toks, cfg, 16, 16)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert got.shape == (2, 3, 32, 32) and float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_sd_finetune_step_gradient_through_the_kernel(cuda_device):
    """A finetune step of a 2-level UNet at 32^2 latents: its four (2, 1, 256, 64) self-attentions run the
    kernel under autograd (FlashAttention) and the step's gradient (AdamW's first moment / 0.1) matches the
    CPU's."""
    from maua_tpu_torch import transforms as T
    from maua_tpu_torch.diffusion import finetune as DF
    from maua_tpu_torch.diffusion.models import unet as U
    from maua_tpu_torch.diffusion.samplers import make_ddpm_schedule
    from maua_tpu_torch.gan.training import tree_leaves
    from maua_tpu_torch.utility import to_device

    cfg = U.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
                       num_heads=1, context_dim=64)
    params = U.init_params(cfg, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    lat, noise = torch.randn(2, 4, 32, 32, generator=gen), torch.randn(2, 4, 32, 32, generator=gen)
    ctx, t = torch.randn(2, 16, 64, generator=gen), torch.tensor([100, 700])
    ac = make_ddpm_schedule(1000)
    mus = {}
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda_device):
            p = to_device(params, dev)
            tx = T.adamw(1e-4)
            A.reset_launches()
            _, st, _ = DF.train_step(p, tx.init(tree_leaves(p)), tx, lat.to(dev), ctx.to(dev), t.to(dev),
                                     noise.to(dev), ac, cfg)
            mus[str(dev)] = [m.cpu() for m in st[0]["mu"]]
        assert A.launches == 4  # the (2, 1, 256, 64) self-attentions: one down, the middle, two up
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    top = max(float(m.abs().max()) for m in mus["cpu"])
    for got, want in zip(mus[str(cuda_device)], mus["cpu"]):
        assert float((got - want).abs().max()) <= max(1e-3 * float(want.abs().max()), 1e-7 * top)


def codec_frames(T: int = 6, size: int = 128, seed: int = 0):
    """A smooth crossfade between two structured images with a static texture and sparse impulses: order-2
    positions and escapes engage at this size."""
    import numpy as np

    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    a = np.stack([128 + 90 * np.sin(xx / 7.0) * np.cos(yy / 11.0), 128 + 70 * np.cos(xx / 13.0),
                  128 + 50 * np.sin(yy / 9.0)], -1)
    b = np.stack([128 - 80 * np.cos(xx / 9.0), 128 + 85 * np.sin((xx + yy) / 15.0), 128 - 60 * np.cos(yy / 8.0)], -1)
    tex = rs.randn(size, size, 3).astype(np.float32) * 2.0
    frames = []
    for t in np.linspace(0.0, 1.0, T, dtype=np.float32):
        s = t * t * (3.0 - 2.0 * t)
        f = np.clip(np.round((1 - s) * a + s * b + tex), 0, 255).astype(np.uint8)
        pts = rs.randint(0, size, size=(20, 2))
        f[pts[:, 0], pts[:, 1]] = rs.randint(0, 256, size=(20, 3))
        frames.append(f)
    return torch.from_numpy(np.stack(frames))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(escape="force", order2="force"), dict(escape="force", chroma_step=2),
                                dict(escape=False, order2=False)], ids=["order2", "chroma2", "clipped"])
def test_codec_on_the_card_equals_the_cpu(cuda_device, kw):
    """The frame codec's device calibration and encodes on the card give the CPU's plan and bytes: its
    arithmetic is elementwise f32 in a fixed order (no matmul), so nothing can round differently."""
    import numpy as np

    from maua_tpu_torch.ops import framecodec as FC

    frames = codec_frames()
    plans = {d: FC.calibrate_chunk_device(frames.to(d), **kw) for d in ("cpu", cuda_device)}
    assert plans["cpu"] == plans[cuda_device]
    codec = plans["cpu"]
    on = {d: [t.cpu().numpy() for t in FC.encode_chunk(frames.to(d), codec)] for d in ("cpu", cuda_device)}
    for got, want in zip(on[cuda_device], on["cpu"]):
        assert np.array_equal(got, want)
    cfg = codec.intra
    assert np.array_equal(FC.encode_frames(frames.to(cuda_device), cfg).cpu().numpy(),
                          FC.encode_frames(frames, cfg).numpy())


@pytest.mark.cuda
def test_dct_delivery_on_the_card_equals_the_cpu(cuda_device):
    """pipelined_frames(..., "dct") over card batches (a padded tail) hands out the CPU route's frames."""
    import numpy as np

    frames = codec_frames(T=10, size=64)

    def batches(dev):
        for lo in range(0, 10, 4):
            b = frames[lo:lo + 4]
            n = b.shape[0]
            if n < 4:
                b = torch.cat([b, b[-1:].repeat(4 - n, 1, 1, 1)])
            yield b.to(dev) * 1, n

    got = list(V.pipelined_frames(batches(cuda_device), "dct"))
    want = list(V.pipelined_frames(batches("cpu"), "dct"))
    assert len(got) == len(want) == 10 and all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_quantile_device_on_the_card_matches_numpy(cuda_device):
    """Past torch.quantile's 2^24-element limit: the sort-based quantiles on the card against numpy's."""
    import numpy as np

    from maua_tpu_torch import native

    x = torch.randn(2**24 + 4097, generator=torch.Generator().manual_seed(9))
    qs = [0.0, 0.001, 0.5, 0.999, 1.0]
    got = native.quantile_device(x.to(cuda_device), qs).cpu().numpy()
    want = np.quantile(x.numpy(), qs)
    assert np.allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the custom ops and serving (platform layer)
def _op_cases(device):
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    up_f, down_f = _lowpass(12, 6.0, 64.0, 32.0), _lowpass(12, 3.0, 32.0, 16.0)
    z, post, noise, bias = rnd(2, 32, 16, 16), rnd(2, 32), rnd(1, 1, 16, 16), rnd(32)
    q, k, v = rnd(1, 2, 256, 64), rnd(1, 2, 256, 64), rnd(1, 2, 256, 64)
    x = rnd(2, 4, 16, 16)
    return [
        ("modconv_epilogue", E, lambda: E.epilogue_op(z, post, noise, bias, None, 0.2, 2 ** 0.5, 256.0),
         lambda: E.modconv_epilogue_plain(z, post, noise, bias), (z, post, noise, bias), 1e-5),
        ("flash_attention", A, lambda: A.flash_attention_op(q, k, v, 0.125),
         lambda: A.flash_attention_plain(q, k, v, 0.125), (q, k, v), 1e-4),
        ("filtered_lrelu", FL, lambda: FL.filtered_lrelu_op(x, [float(f) for f in up_f], [float(f) for f in down_f],
                                                          2, 2, None, None, None, None),
         lambda: FL.filtered_lrelu_plain(x, up_f, down_f, 2, 2), (x,), 1e-4),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1, 2])
def test_custom_op_launches_its_kernel_on_the_card(cuda_device, case):
    name, module, op, plain, _, tol = _op_cases(cuda_device)[case]
    module.reset_launches()
    got, want = op(), plain()
    assert module.launches == 1, name
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1, 2])
def test_exported_graph_calls_the_kernel(cuda_device, case, tmp_path):
    """A torch.export program of each op, saved and loaded, launches the kernel when it runs on the card."""
    from maua_tpu_torch import export as EX

    name, module, _, plain, inputs, tol = _op_cases(cuda_device)[case]
    wrappers = {
        "modconv_epilogue": lambda z, post, noise, bias: E.modconv_epilogue(z, post, noise, bias),
        "flash_attention": lambda q, k, v: A.flash_attention_fused(q, k, v, 0.125),
        "filtered_lrelu": lambda x: FL.filtered_lrelu(x, _lowpass(12, 6.0, 64.0, 32.0), _lowpass(12, 3.0, 32.0, 16.0),
                                                      2, 2),
    }
    path = EX.export_fn(wrappers[name], inputs, str(tmp_path / f"{name}.pt2"))
    call = EX.load_exported(path)
    module.reset_launches()
    got = call(*inputs)
    assert module.launches == 1, name
    torch.testing.assert_close(got, plain(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_gan_service_batches_run_bare_on_the_worker_thread(cuda_device):
    """The batcher's worker starts with grad enabled (grad mode is thread-local): the service enters
    inference mode itself, so its kernels launch bare and no autograd graph is recorded."""
    from maua_tpu_torch import serve as SV
    from maua_tpu_torch.gan import stylegan2 as TG
    from maua_tpu_torch.gan import wrappers as TGW

    gen = TGW.StyleGAN2(cfg=TG.SG2Config(img_resolution=32, z_dim=16, w_dim=16, channel_base=1024, channel_max=32,
                                         num_fp16_res=0), device=cuda_device)
    outs = []
    synth = gen.synthesizer

    def spy(ws, **kw):
        out = synth(ws, **kw)
        outs.append((out.is_inference(), out.requires_grad, out.grad_fn))
        return out

    gen.synthesizer = spy
    svc = SV.GANImageService(generator=gen, max_batch=4, max_wait_ms=10.0)
    try:
        E.reset_launches()
        frame = svc.submit({"seed": 2}).result(timeout=300)
    finally:
        svc.close()
    assert frame.shape == (32, 32, 3) and outs == [(True, False, None)]
    assert E.launches == 7  # b4 conv1 and two convs in each of b8, b16 and b32


@pytest.mark.cuda
@pytest.mark.parametrize("b,ci,h,w,co,k", [
    (2, 128, 32, 32, 256, 3),  # the s2d tail's b512 conv0 cells, cut in size
    (1, 256, 20, 24, 256, 3),  # its conv1
    (2, 64, 33, 35, 128, 3),  # b1024 conv0, sizes off the 16-pixel tile
    (1, 323, 36, 36, 203, 3),  # StyleGAN3 T's ragged trunk channels
    (2, 81, 37, 45, 51, 3),
    (1, 51, 52, 52, 3, 3),  # Co below one n8 tile
    (2, 40, 19, 23, 70, 1),  # a 1x1 kernel
    (1, 33, 1, 17, 32, 3),  # one row
    (2, 40, 13, 48, 200, 3),  # W % 16 == 0: the TMA route, H and Co off the tile
    (1, 51, 20, 36, 81, 3),  # W % 4 == 0 but not % 16 (StyleGAN3 T's 36 and 52): cp.async, 16-byte row stores
    (2, 60, 10, 52, 96, 3),
    (1, 64, 12, 20, 512, 3),  # Co 512: two 256-channel tiles
    (5, 16, 3, 5, 24, 3),  # a batch of small images: each block's tiles span images
    (1, 40, 5, 64, 70, 3),  # W % 64 == 0: 1 x 64 pixel patches, TMA
    (1, 20, 6, 532, 51, 3),  # W >= 256 (StyleGAN3 T's 532): 1 x 64 patches, cp.async
    (1, 64, 4, 256, 256, 3),  # StyleGAN2's b512 cells: 1 x 64 patches, two 128-channel tiles, TMA
])
def test_conv_i8_kernel_matches_plain(cuda_device, b, ci, h, w, co, k):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-127, 128, (b, ci, h, w), generator=gen, device=cuda_device, dtype=torch.int8)
    wt = torch.randint(-127, 128, (co, ci, k, k), generator=gen, device=cuda_device, dtype=torch.int8)
    CI.reset_launches()
    out = CI.conv_i8(x, wt)
    torch.cuda.synchronize()
    assert CI.launches == 1 and out.dtype == torch.float32 and out.shape == (b, co, h, w)
    assert torch.equal(out, CI.conv_i8_plain(x, wt))
    assert CI.staging_route(x) == ("tma" if w % 16 == 0 else "cp.async")  # x from torch is 16-byte aligned


@pytest.mark.cuda
def test_conv_i8_kernel_sums_exactly_at_the_widest_k(cuda_device):
    """All +-127 at Ci 512, k 3: sums up to 9 * 512 * 127^2 = 74,322,432, past f32's 2^24, exact in int32 and
    rounded to even once."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    sign = lambda *s: torch.randint(0, 2, s, generator=gen, device=cuda_device, dtype=torch.int8) * 2 - 1
    x = torch.full((1, 512, 12, 20), 127, dtype=torch.int8, device=cuda_device)
    x[:, :, :, 10:] *= sign(1, 512, 12, 10)
    wt = torch.full((40, 512, 3, 3), 127, dtype=torch.int8, device=cuda_device)
    wt[20:] = -127
    out = CI.conv_i8(x, wt)
    want = CI.conv_i8_int32(x, wt)
    assert int(want.abs().max()) == 9 * 512 * 127**2
    assert torch.equal(out, want.float())


@pytest.mark.cuda
def test_conv_i8_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 8, 6, 6, dtype=torch.int8, device=cuda_device)
    w = torch.zeros(4, 8, 3, 3, dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        CI.conv_i8(x.float(), w)
    with pytest.raises(ValueError, match="1x1 and 3x3"):
        CI.conv_i8(x, torch.zeros(4, 8, 5, 5, dtype=torch.int8, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        CI.conv_i8(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="device"):
        CI.conv_i8(x, w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,noise_shape,use_pre,clamp", [
    ((8, 256, 64, 64), (1, 4, 64, 64), True, 256.0),  # the s2d route's int8 cells: 16 codes a store
    ((2, 128, 32, 32), (2, 4, 32, 32), True, None),
    ((3, 5, 7, 9), (3, 1, 7, 9), True, 256.0),  # H*W not a multiple of 16: the scalar path
    ((2, 16, 8, 8), None, False, 256.0),
])
def test_epilogue_int8_output_matches_plain(cuda_device, dtype, shape, noise_shape, use_pre, clamp):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, c = shape[:2]
    z = (torch.randn(*shape, generator=gen, device=cuda_device) * 4).to(dtype)
    post = torch.rand(b, c, generator=gen, device=cuda_device) + 0.5
    noise = None if noise_shape is None else torch.randn(*noise_shape, generator=gen, device=cuda_device)
    bias = torch.randn(c, generator=gen, device=cuda_device)
    pre = (torch.rand(b, c, generator=gen, device=cuda_device) + 0.5) * 20 if use_pre else None
    E.reset_launches()
    out = E.modconv_epilogue(z, post, noise, bias, clamp=clamp, pre_next=pre, quant_out=True)
    torch.cuda.synchronize()
    assert E.launches == 1 and E.int8_launches == 1 and out.dtype == torch.int8
    ref = E.modconv_epilogue_plain(z, post, noise, bias, clamp=clamp, pre_next=pre, quant_out=True)
    diff = (out.int() - ref.int()).abs()
    assert int(diff.max()) <= 1 and (not use_pre or int(ref.abs().max()) == 127)  # the large pre_next clips


def _int8_routes():
    """A 32^2 StyleGAN2 on s2d cells throughout and a 64^2 StyleGAN3, parameters from seed 0 on the CPU, with
    int8 plans calibrated there."""
    from maua_tpu_torch.gan import fast_synthesis as FS
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.gan import stylegan3 as S3

    cfg2 = S2.SG2Config(img_resolution=32, channel_base=1024, channel_max=64, z_dim=32, w_dim=32, mapping_layers=2)
    p2 = S2.init_params(cfg2, torch.Generator().manual_seed(0))
    plan2 = FS.quantize_plan(p2, FS.build_fast_plan(p2, cfg2, min_channels=9999), cfg2, batch=2)
    cfg3 = S3.SG3Config(z_dim=32, w_dim=32, img_resolution=64, channel_base=1024, channel_max=64, num_layers=6,
                        mapping_layers=2, margin_size=4)
    p3 = S3.init_params(cfg3, torch.Generator().manual_seed(0))
    plan3 = S3.quantize_sg3(p3, cfg3, batch=2)
    return (cfg2, p2, plan2), (cfg3, p3, plan3)


@pytest.mark.cuda
def test_int8_routes_on_the_card_match_the_cpu(cuda_device, no_tf32):
    from maua_tpu_torch.gan import fast_synthesis as FS
    from maua_tpu_torch.gan import stylegan2 as S2
    from maua_tpu_torch.gan import stylegan3 as S3
    from maua_tpu_torch.utility import to_device

    (cfg2, p2, plan2), (cfg3, p3, plan3) = _int8_routes()
    ws2 = S2.mapping(p2, torch.randn(2, cfg2.z_dim, generator=torch.Generator().manual_seed(1)), cfg2)
    ws3 = S3.mapping(p3, torch.randn(2, cfg3.z_dim, generator=torch.Generator().manual_seed(1)), cfg3)
    E.reset_launches(), CI.reset_launches(), FL.reset_launches()
    with torch.no_grad():
        card2 = FS.synthesis_fast(to_device(p2, cuda_device), FS.device_plan(plan2, cfg2, cuda_device),
                                  ws2.to(cuda_device), cfg2, noise_mode="const")
        assert (E.launches, E.int8_launches, CI.launches) == (1 + 2 * 3, 3, 2 * 3)  # b4 plain, b8..b32 on cells
        card3 = S3.synthesis(to_device(p3, cuda_device), ws3.to(cuda_device), cfg3,
                             int8_plan=S3.int8_plan_to_device(plan3, cuda_device))
        assert CI.launches == 2 * 3 + cfg3.num_layers - 1 and FL.launches == cfg3.num_layers - 1
        host2 = FS.synthesis_fast(p2, FS.device_plan(plan2, cfg2, "cpu"), ws2, cfg2, noise_mode="const")
        host3 = S3.synthesis(p3, ws3, cfg3, int8_plan=plan3)
    for card, host in ((card2, host2), (card3, host3)):
        mse = float((card.cpu().double() - host.double()).pow(2).mean())
        assert 10 * math.log10(4.0 / max(mse, 1e-20)) >= 40.0

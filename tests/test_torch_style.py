"""The port's parameterizations and style transfer against maua_tpu's, on
the CPU.

Parameterizations (rgb, fourier, pixel, vqgan) take the same tensors
(maua_tpu's draws handed over: the pixel logits, VQGAN's z, codebook and
AutoencoderKL decoder through `diffusion_params_to_torch`): decode, encode,
the EMA's decode_average, the palette losses, and the gradient of a
random linear loss through each decode. Then the style slices with the same
seed-0 VGG19 (maua_tpu's init_params through `guidance_params_to_torch`)
and the same histogram-matching jitter (maua_tpu's draws): `transfer` with
L-BFGS at 32^2 and with Adam and an EMA decode at 24^2, `transfer_multires`
(Adam) over 16^2 and 24^2, and the flow-consistent video over a 3-frame 32^2 clip
(3 passes, so the middle one blends; the temporal loss on; Farneback
flow, each package computing and caching its own).

Tolerances, f32: decodes, encodes, EMA decodes and the losses within 1e-5
(absolute, of images in [-1, 1], or relative for losses and spectra);
gradients within 1e-4 of their largest magnitude; every style slice's
output PSNR >= 40 dB (peak 2, the [-1, 1] range; printed).
"""

import math
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.flow.lib as JLIB
from maua_tpu.diffusion.models import vae as JVAE
from maua_tpu.parameterizations import load_parameterization as jax_param
from maua_tpu.perceptors import vgg as JVGG
from maua_tpu.style import image as JSI
from maua_tpu.style import multires as JSM
from maua_tpu.style import video as JSV
from maua_tpu_torch import utility
from maua_tpu_torch.bridge import diffusion_params_to_torch, guidance_params_to_torch
from maua_tpu_torch.ops import image as TI
from maua_tpu_torch.ops.video import write_video
from maua_tpu_torch.parameterizations import load_parameterization
from maua_tpu_torch.parameterizations.vqgan import VQGAN_VAE
from maua_tpu_torch.style import image as TSI
from maua_tpu_torch.style import multires as TSM
from maua_tpu_torch.style import video as TSV
from test_torch_image_ops import jax_jitter


def _psnr(a, b):
    a, b = np.clip(np.asarray(a), -1, 1), np.clip(np.asarray(b), -1, 1)
    return 10 * math.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def _close(got, want, atol, what=""):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= atol, (what, err)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grads_match(jax_decode, jax_tensor, port, weight):
    """The gradient of sum(decode * weight) in both packages, within 1e-4 of its largest magnitude."""
    want = jax.jit(jax.grad(lambda t: jnp.sum(jax_decode(t) * weight)))(jax_tensor)
    for p in port.params():
        p.grad = None
    (port.decode() * torch.from_numpy(weight)).sum().backward()
    got = port.tensor.grad if not isinstance(port.tensor, dict) else {k: v.grad for k, v in port.tensor.items()}
    for g, w in (zip(got.values(), [want[k] for k in got]) if isinstance(got, dict) else [(got, want)]):
        w = np.asarray(w)
        assert np.abs(_np(g) - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12)


@pytest.fixture(scope="module")
def vgg():
    params = jax.tree_util.tree_map(np.asarray, JVGG.init_params(jax.random.PRNGKey(0), "vgg19"))
    return params, guidance_params_to_torch(params)


@pytest.fixture()
def jitter(monkeypatch):
    """The port's histogram matching in the style modules takes maua_tpu's jitter draws."""
    def matching(target, source, mode="avg", **kw):
        sources = source if isinstance(source, (list, tuple)) else [source]
        return TI.match_histogram(target, source, mode, noise=iter(jax_jitter(target.shape, [s.shape for s in sources])))

    for module in (TSI, TSV):
        monkeypatch.setattr(module, "match_histogram", matching)


# ------------------------------------------------------------------ parameterizations
def test_rgb_decode_ema_and_gradient():
    rs = np.random.RandomState(10)
    img = (rs.rand(1, 16, 16, 3) * 2.2 - 1.1).astype(np.float32)
    j, t = jax_param("rgb")(16, 16, tensor=img, ema=True), load_parameterization("rgb")(16, 16, tensor=img, ema=True,
                                                                                        device="cpu")
    _close(t.decode().detach(), j.decode(), 1e-5, "decode")
    for step in range(3):
        new = (rs.rand(1, 16, 16, 3) * 1.2 - 0.1).astype(np.float32)
        j.set_params(jnp.asarray(new))
        t.set_params(torch.from_numpy(new))
        j.update_ema()
        t.update_ema()
    _close(t.decode_average(), j.decode_average(), 1e-5, "decode_average")
    weight = rs.randn(1, 16, 16, 3).astype(np.float32)
    _grads_match(j.decode, j.tensor, t, weight)
    j.encode(img)
    t.encode(img)
    _close(t.tensor.detach(), j.tensor, 1e-6, "encode")


def test_fourier_decode_encode_and_gradient():
    rs = np.random.RandomState(11)
    spec = (rs.randn(1, 3, 16, 9, 2) * 0.05).astype(np.float32)
    j, t = jax_param("fourier")(16, 16, tensor=spec), load_parameterization("fourier")(16, 16, tensor=spec,
                                                                                        device="cpu")
    _close(t.decode().detach(), j.decode(), 1e-5, "decode")
    _grads_match(j.decode, j.tensor, t, rs.randn(1, 16, 16, 3).astype(np.float32))
    img = (rs.rand(1, 16, 16, 3) * 1.2 - 0.6).astype(np.float32)
    j.encode(img)
    t.encode(img)
    want = np.asarray(j.tensor)
    assert np.abs(_np(t.tensor) - want).max() <= 1e-5 * np.abs(want).max()
    _close(t.decode().detach(), j.decode(), 1e-5, "decode of the encoded image")


def test_pixel_decode_losses_encode_and_gradient():
    rs = np.random.RandomState(12)
    j = jax_param("pixel")(16, 16, n_colors=4, scale=2, ema=True, key=jax.random.PRNGKey(1))
    t = load_parameterization("pixel")(16, 16, n_colors=4, scale=2, ema=True, device="cpu")
    tree = {"value": rs.rand(8, 8).astype(np.float32) * 1.2 - 0.1, "tensor": np.asarray(j.tensor["tensor"]),
            "pallet": np.asarray(j.tensor["pallet"]) * (1 + 0.3 * rs.rand(4, 2, 3)).astype(np.float32)}
    j.set_params({k: jnp.asarray(v) for k, v in tree.items()})
    t.set_params({k: torch.from_numpy(v) for k, v in tree.items()})
    j.reset_ema()
    t.reset_ema()
    _close(t.decode().detach(), j.decode(), 1e-5, "decode")
    for fn in ("palette_loss", "hdr_loss"):
        want = float(getattr(j, fn)())
        assert abs(float(getattr(t, fn)()) - want) <= 1e-5 * abs(want), fn
    j.update_ema()
    t.update_ema()
    _close(t.decode_average(), j.decode_average(), 1e-5, "decode_average")
    weight = rs.randn(1, 16, 16, 3).astype(np.float32)
    _grads_match(j.decode, j.tensor, t, weight)
    for hard in (True,):
        j.hard = t.hard = hard
        _grads_match(j.decode, j.tensor, t, weight)
    img = (rs.rand(1, 16, 16, 3) * 2 - 1).astype(np.float32)
    j.encode(img)
    t.encode(img)
    for k in ("value", "tensor", "pallet"):
        _close(t.tensor[k].detach(), j.tensor[k], 1e-5 * max(1.0, float(np.abs(np.asarray(j.tensor[k])).max())), k)
    _close(t.decode().detach(), j.decode(), 1e-5, "decode of the encoded image")


def test_vqgan_decode_encode_and_gradient():
    """64^2: the decoder's mid attention (N 256, D 128) takes the kernel route's FlashAttention under autograd."""
    key = jax.random.PRNGKey(0)
    j = jax_param("vqgan")(64, 64, key=key)
    j.decode_fn, j.encode_fn = jax.jit(j.decode_fn), jax.jit(j.encode_fn)  # one compile each, not one per op
    vae = jax.tree_util.tree_map(np.asarray, JVAE.init_params(key, JVAE.VAEConfig(**VQGAN_VAE)))
    t = load_parameterization("vqgan")(64, 64, tensor=np.asarray(j.tensor), codebook=np.asarray(j.codebook),
                                       vae_params=diffusion_params_to_torch(vae), device="cpu")
    assert tuple(t.tensor.shape) == (1, 16, 16, 4)
    _close(t.decode().detach(), j.decode(), 1e-5, "decode")
    _grads_match(j.decode, j.tensor, t, np.random.RandomState(13).randn(1, 64, 64, 3).astype(np.float32))
    img = (np.random.RandomState(14).rand(1, 64, 64, 3) * 2 - 1).astype(np.float32)
    _close(t.encode(img).detach(), j.encode(jnp.asarray(img)), 1e-5, "encode")
    _close(t.decode().detach(), j.decode(), 1e-5, "decode of the encoded image")
    with pytest.raises(NotImplementedError, match="stylegan2.py's Generator"):
        load_parameterization("stylegan")


# ------------------------------------------------------------------ style slices
def _content_style(seed, size):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    content = np.stack([0.5 + 0.3 * np.sin(9 * x), y, 0.5 + 0.4 * np.cos(7 * (x + y))], -1)[None].astype(np.float32)
    return content, rs.rand(1, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("optimizer,size,n_iters,ema", [("lbfgs", 32, 4, False), ("adam", 24, 6, True)])
def test_image_transfer_matches(optimizer, size, n_iters, ema, vgg, jitter):
    content, style = _content_style(20, size)
    kw = dict(size=size, optimizer=optimizer, lr=0.5 if optimizer == "lbfgs" else 0.05, n_iters=n_iters, ema=ema,
              tv_weight=10.0, verbose=False)
    want = np.asarray(JSI.transfer(content, [style], perceptor_kwargs={"params": vgg[0]}, **kw))
    stats = {}
    got = TSI.transfer(content, [style], perceptor_kwargs={"params": vgg[1]}, device="cpu", stats=stats, **kw)
    psnr = _psnr(got, want)
    print(f"{optimizer}: {psnr:.1f} dB, moved {np.abs(want - (content * 2 - 1)).max():.3f}, {stats}")
    assert got.shape == (1, size, size, 3) and psnr >= 40
    assert np.abs(want - (content * 2 - 1)).max() > 0.05  # the optimization moved the image
    if optimizer == "lbfgs":
        assert stats["evaluations"] > n_iters


def test_image_transfer_refuses_an_image_as_a_latent(vgg):
    content, style = _content_style(21, 16)
    with pytest.raises(ValueError, match="init_type='random'"):
        TSI.transfer(content, [style], size=16, parameterization="vqgan", device="cpu", n_iters=1, verbose=False,
                     perceptor_kwargs={"params": vgg[1]})


def test_transfer_multires_matches(vgg, jitter):
    content, style = _content_style(22, 32)
    # Adam (its loop compiles in a third of L-BFGS's time) at a small lr: Adam divides each pixel's gradient by
    # its own running RMS, so where a gradient is near zero its roundoff sets a step of up to lr (at lr 0.05 an
    # edge pixel parts by 1.2e-3 after two steps at 16^2)
    kw = dict(sizes=(16, 24), n_iters_per_scale=(2, 2), match_hist="False", tv_weight=10.0, optimizer="adam", lr=0.01,
              verbose=False)
    want = np.asarray(JSM.transfer_multires(content, [style], perceptor_kwargs={"params": vgg[0]}, **kw))
    got = TSM.transfer_multires(content, [style], perceptor_kwargs={"params": vgg[1]}, device="cpu", **kw)
    psnr = _psnr(got, want)
    print(f"multires: {psnr:.1f} dB")
    assert got.shape == (1, 24, 24, 3) and psnr >= 40


@pytest.fixture()
def clip_and_style(tmp_path, monkeypatch):
    path = str(tmp_path / f"clip_{uuid.uuid4().hex[:8]}.mp4")
    rs = np.random.RandomState(23)
    base = np.repeat(np.repeat(rs.rand(8, 8, 3), 4, 0), 4, 1).astype(np.float32) * 0.8 + 0.1
    write_video(np.stack([np.roll(base, s, axis=1) for s in range(3)]), path, fps=8, value_range=(0, 1))
    monkeypatch.setattr(JLIB, "WORKSPACE", str(tmp_path / "jax"))
    monkeypatch.setattr(utility, "WORKSPACE", str(tmp_path / "port"))
    return path, _content_style(24, 32)[1]


def test_video_transfer_matches(vgg, clip_and_style, jitter):
    clip, style = clip_and_style
    kw = dict(size=32, n_passes=3, n_iters=6, temporal_loss_after=0, blend_factor=1.0, match_hist="avg",
              flow_models=("farneback",), verbose=False)
    want = JSV.transfer(clip, [style], perceptor_kwargs={"params": vgg[0]}, **kw)
    stages = {}
    got = TSV.transfer(clip, [style], perceptor_kwargs={"params": vgg[1]}, device="cpu", stage_times=stages, **kw)
    psnr = _psnr(got, want)
    print(f"video: {psnr:.1f} dB, {stages}")
    assert got.shape == want.shape == (3, 32, 32, 3) and psnr >= 40
    assert set(stages) == {"flow", "passes"}

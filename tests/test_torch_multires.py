"""The port's multi-size diffusion pipeline (maua_tpu_torch/diffusion/image.py:
inits, super-resolution between sizes, lanczos resampling, tiles and their
batches, the histogram and sharpening hooks) and its perlin noise, against
maua_tpu's, on the CPU in f32.

The orchestration runs both packages' MultiResolutionDiffusionProcessor
(through `image_sample`) around the same deterministic stand-in
processor, so that init, super-resolution (a 2-block RRDBNet loaded by
both from one basicsr file), resample, destitch / restitch, the tile
batches and the hooks are compared alone: 1e-4 absolute on images in
[-1, 1]. The perlin gradients and the histogram jitter are maua_tpu's
draws handed to the port. The slice as a whole (the tiny Stable
Diffusion of tests/test_torch_diffusion.py, 64^2 then 128^2 in nine 64^2
tiles, with maua_tpu's noise for every call): PSNR >= 40 dB (peak 2).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from maua_tpu.diffusion import image as JD
from maua_tpu.diffusion.processors.base import BaseDiffusionProcessor as JaxBase
from maua_tpu.ops import noise as JN
from maua_tpu.super import image as JSI
from maua_tpu.super.models import rrdbnet as JR
from maua_tpu_torch import utility
from maua_tpu_torch.diffusion import image as TD
from maua_tpu_torch.diffusion.processors.base import BaseDiffusionProcessor
from maua_tpu_torch.ops import image as TImg
from maua_tpu_torch.ops import noise as TN
from maua_tpu_torch.super import image as TSI
from maua_tpu_torch.super.models import rrdbnet as TR
from test_torch_diffusion import pair, text_params, unet_params, vae_params  # noqa: F401 (fixtures)
from test_torch_image_ops import jax_jitter

TINY_RRDB = dict(num_feat=8, num_block=2, num_grow_ch=4)
TOL = 1e-4


def jax_gradients(key, octaves, width, height, channels):
    """maua_tpu's perlin gradient draws in the port's order (channel, then octave)."""
    out = []
    for c in range(channels):
        ow, oh = width, height
        for i in range(len(octaves)):
            g = jax.random.normal(jax.random.fold_in(key, c * 1000 + i), (2, ow + 1, oh + 1, 1, 1))
            out.append(np.asarray(g))
            ow, oh = ow * 2, oh * 2
    return out


@pytest.mark.parametrize("grayscale", [True, False])
def test_perlin_noise_matches_with_the_same_gradients(grayscale):
    key = jax.random.PRNGKey(3)
    octaves = [1.5**-i * 0.5 for i in range(4)]
    ref = np.asarray(jax.jit(lambda k: JN.create_perlin_noise(k, octaves, 2, 3, grayscale=grayscale))(key))
    grads = jax_gradients(key, octaves, 2, 3, 1 if grayscale else 3)
    out = TN.create_perlin_noise(torch.Generator(), octaves, 2, 3, grayscale=grayscale, gradients=grads).numpy()
    assert out.shape == ref.shape == (32, 48, 3)
    assert np.abs(out - ref).max() <= 1e-5
    drawn = TN.create_perlin_noise(torch.Generator().manual_seed(0), octaves, 2, 3, grayscale=grayscale)
    assert drawn.shape == ref.shape and float(drawn.min()) == 0.0 and float(drawn.max()) == 1.0


def test_perlin_and_file_inits_match(monkeypatch, tmp_path):
    """The perlin init's composition (a colour and a grey noise, bicubic to the
    size, summed) with the octave lists cut to four, so that the noises are
    16^2 and 64^2 here rather than 4096^2 and 1024^2; and the file init."""
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    real_jax, real_torch = JN.create_perlin_noise, TN.create_perlin_noise
    monkeypatch.setattr(JD, "create_perlin_noise",
                        lambda k, octv, w, h, grayscale: real_jax(k, octv[:4], w, h, grayscale))

    def port_noise(gen, octv, w, h, grayscale):
        k = k2 if grayscale else k1
        grads = jax_gradients(k, octv[:4], w, h, 1 if grayscale else 3)
        return real_torch(gen, octv[:4], w, h, grayscale=grayscale, gradients=grads)

    monkeypatch.setattr(TD, "create_perlin_noise", port_noise)
    ref = np.asarray(jax.jit(lambda k: JD.initialize_image("perlin", (40, 56), k))(key))
    out = TD.initialize_image("perlin", (40, 56), torch.Generator()).numpy()
    assert out.shape == ref.shape == (1, 40, 56, 3)
    assert np.abs(out - ref).max() <= 1e-5

    path = str(tmp_path / "init.png")
    Image.fromarray((np.random.RandomState(6).rand(30, 50, 3) * 255).astype(np.uint8)).save(path)
    ref = np.asarray(JD.initialize_image(path, (64, 128), key))
    out = TD.initialize_image(path, (64, 128), torch.Generator()).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    with pytest.raises(Exception, match="not recognized"):
        TD.initialize_image(None, (64, 64), torch.Generator())


def _standin(img, t_start, xp):
    return xp.tanh(img * (1.5 - t_start)) * 0.9 + 0.05 * xp.sin(3 * img)


class JaxStandIn(JaxBase):
    image_size = 64

    def __init__(self):
        self.calls = []

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, key=None):
        self.calls.append((img.shape[0], t_start, sorted(type(p).__name__ for p in prompts)))
        return _standin(jnp.asarray(img), t_start, jnp)


class TorchStandIn(BaseDiffusionProcessor):
    image_size = 64
    device = torch.device("cpu")

    def __init__(self, oom_at=()):
        self.calls = []
        self.oom_at = list(oom_at)

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, gen=None, noise=None, stage_times=None):
        self.calls.append((img.shape[0], t_start, sorted(type(p).__name__ for p in prompts)))
        if len(self.calls) in self.oom_at:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")
        return _standin(img, t_start, torch)


@pytest.fixture
def tiny_sr(monkeypatch, tmp_path):
    """A "tiny" RRDBNet x4 in both registries, loaded by both from one basicsr .pth."""
    import maua_tpu.super.image as jsi_module

    monkeypatch.setitem(JSI.MODEL_REGISTRY, "tiny", ("rrdb", JR.RRDBConfig(**TINY_RRDB)))
    monkeypatch.setitem(TSI.MODEL_REGISTRY, "tiny", ("rrdb", TR.RRDBConfig(**TINY_RRDB)))
    for files in (JSI._CHECKPOINT_FILES, TSI._CHECKPOINT_FILES):
        monkeypatch.setitem(files, "tiny", "tiny.pth")
    monkeypatch.setattr(jsi_module, "MODELZOO", str(tmp_path))
    monkeypatch.setattr(utility, "MODELZOO", str(tmp_path))
    params = TR.init_params(torch.Generator().manual_seed(7), TR.RRDBConfig(**TINY_RRDB))
    torch.save({"params_ema": chip_smoke.rrdb_state_dict(params)}, tmp_path / "tiny.pth")
    return tmp_path


def _write(tmp_path, name, seed, size):
    path = str(tmp_path / name)
    Image.fromarray((np.random.RandomState(seed).rand(*size, 3) * 255).astype(np.uint8)).save(path)
    return path


def test_multires_orchestration_matches(tiny_sr, monkeypatch):
    init = _write(tiny_sr, "init.png", 8, (48, 80))
    style = _write(tiny_sr, "style.png", 9, (40, 40))
    monkeypatch.setattr(TD, "match_histogram", lambda img, src: TImg.match_histogram(
        img, src, noise=iter(jax_jitter(img.shape, [src.shape]))))
    kw = dict(init=init, text="a fox", style=style, sizes=((64, 64), (128, 128)), skips=(0.3, 0.5),
              super_res_model="tiny", max_batch=4, match_hist=True, sharpness=0.7, verbose=False)
    jproc, tproc = JaxStandIn(), TorchStandIn()
    ref = np.asarray(JD.image_sample(diffusion=jproc, **kw))
    stages = {}
    out = TD.image_sample(diffusion=tproc, stage_times=stages, **kw).numpy()
    assert out.shape == ref.shape == (1, 128, 128, 3)
    print(f"orchestration: max abs err {np.abs(out - ref).max():.3g}")
    assert np.abs(out - ref).max() <= TOL
    # one call at 64^2 with the content prompt, then the nine 64^2 tiles in batches of 4, 4 and 1 without it
    assert tproc.calls == jproc.calls
    assert [c[0] for c in tproc.calls] == [1, 4, 4, 1] and "ContentPrompt" in tproc.calls[0][2]
    assert set(stages) == {"super_res", "resample", "stitch"}


def test_tile_batches_halve_when_the_card_runs_out_of_memory(tiny_sr, capsys):
    kw = dict(init=_write(tiny_sr, "init.png", 10, (64, 64)), sizes=((64, 64), (128, 128)), skips=(0.0, 0.5),
              max_batch=4, verbose=False)
    want = TD.image_sample(diffusion=TorchStandIn(), **kw)
    proc = TorchStandIn(oom_at=[2])  # the first batch of tiles
    out = TD.image_sample(diffusion=proc, **kw)
    assert [c[0] for c in proc.calls] == [1, 4, 2, 2, 2, 2, 1]
    assert "retrying with max_batch=2" in capsys.readouterr().out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        TD.image_sample(diffusion=TorchStandIn(oom_at=[2]), **{**kw, "max_batch": 1, "stitch": True,
                                                                "tile_size": 32, "sizes": ((64, 64),)})


def test_super_resolution_is_skipped_when_the_card_runs_out_of_memory(tiny_sr, monkeypatch, capsys):
    kw = dict(init=_write(tiny_sr, "init.png", 11, (64, 64)), sizes=((64, 64), (128, 128)), skips=(0.0, 0.5),
              verbose=False)
    without = TD.image_sample(diffusion=TorchStandIn(), **kw)
    with_sr = TD.image_sample(diffusion=TorchStandIn(), super_res_model="tiny", **kw)
    assert float((with_sr - without).abs().max()) > 1e-3

    def fails(error):
        def upscale_image(*a, **k):
            raise error

        return upscale_image

    monkeypatch.setattr(TSI, "upscale_image", fails(torch.cuda.OutOfMemoryError("CUDA out of memory.")))
    out = TD.image_sample(diffusion=TorchStandIn(), super_res_model="tiny", **kw)
    assert "continuing without it" in capsys.readouterr().out
    torch.testing.assert_close(out, without, rtol=0, atol=0)
    monkeypatch.setattr(TSI, "upscale_image", fails(RuntimeError("CUDNN_STATUS_EXECUTION_FAILED")))
    with pytest.raises(RuntimeError, match="CUDNN"):
        TD.image_sample(diffusion=TorchStandIn(), super_res_model="tiny", **kw)


def _psnr(a, b):
    a, b = np.clip(a, -1, 1), np.clip(b, -1, 1)
    return 10 * math.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def test_multires_slice_matches(pair, tiny_sr):  # noqa: F811
    """Text to image at 64^2, RRDBNet x4 to 256^2, lanczos to 128^2, nine 64^2
    tiles denoised from t 0.5 in batches of 4, 4 and 1, restitched."""
    jsd, tsd = pair
    kw = dict(text="a lighthouse at dusk", sizes=((64, 64), (128, 128)), skips=(0.0, 0.5),
              super_res_model="tiny", max_batch=4, verbose=False)
    ref = np.asarray(JD.image_sample(diffusion=jsd, **kw))
    lat = (1, 64 // tsd.vae_cfg.downscale, 64 // tsd.vae_cfg.downscale, 4)
    key = jax.random.PRNGKey(0)
    key, _ = jax.random.split(key)  # the init image's draw
    noise = []
    key, sub = jax.random.split(key)
    noise.append(np.asarray(jax.random.normal(jax.random.split(sub)[0], (1,) + lat[1:])))
    key, sub = jax.random.split(key)
    for i, b in ((0, 4), (4, 4), (8, 1)):
        noise.append(np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(sub, i))[0], (b,) + lat[1:])))
    out = TD.image_sample(diffusion=tsd, noise=noise, **kw).numpy()
    assert out.shape == ref.shape == (1, 128, 128, 3)
    print(f"multires slice: max abs err {np.abs(out - ref).max():.3g}, PSNR {_psnr(out, ref):.1f} dB")
    assert _psnr(out, ref) >= 40.0

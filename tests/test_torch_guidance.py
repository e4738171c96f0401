"""The port's guidance stack against maua_tpu's, on the CPU: losses and their
custom gradients (loss.py), cutouts (ops/cutouts.py), the CLIP, VGG and
LPIPS perceptors, every grad module's gradient (grad.py), and
guided_denoiser.

CLIP at a tiny size (a 32^2, patch-8, 32-wide vision tower; the tiny text
tower of tests/test_diffusion_pipeline.py), VGG and LPIPS at their fixed
published widths on small images; every parameter is a numpy draw in
maua_tpu's pytree, carried over by the bridge. JAX keys cannot be
replayed, so JAX's own draws (cutout sizes and offsets) are handed to the
port.

Tolerances, f32: losses and features 1e-5 relative (1e-6 absolute where
values are ~0); gradients of the image 1e-4 of their largest magnitude
(a dozen conv or matmul layers forward and back, summed in other orders
by oneDNN and XLA); the custom gradients exact up to one rounding (1e-6).
LPIPSGrads scores at 256^2, where VGG16's 5.7M relu inputs a layer make
some land within f32 roundoff of 0 (and some max-pool windows within
roundoff of a tie), so the two frameworks route a few gradient paths
differently: its gradient is held to 1e-2 in relative L2 norm (measured
1.4e-3 on a random pair at 256^2; 4.4e-6 at 32^2, where the same nets
agree to 1e-4 elementwise).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu import grad as JG
from maua_tpu import loss as JL
from maua_tpu.diffusion import wrappers as JW
from maua_tpu.ops import cutouts as JC
from maua_tpu.perceptors import clip as JCLIP
from maua_tpu.perceptors import lpips as JLP
from maua_tpu.perceptors import vgg as JVGG
from maua_tpu.prompt import ContentPrompt as JContentPrompt
from maua_tpu.prompt import StylePrompt as JStylePrompt
from maua_tpu.prompt import TextPrompt as JTextPrompt
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch import grad as TG
from maua_tpu_torch import loss as TL
from maua_tpu_torch.diffusion import wrappers as TW
from maua_tpu_torch.ops import cutouts as TC
from maua_tpu_torch.perceptors import clip as TCLIP
from maua_tpu_torch.perceptors import load_perceptor
from maua_tpu_torch.perceptors import lpips as TLP
from maua_tpu_torch.perceptors import vgg as TVGG
from maua_tpu_torch.prompt import ContentPrompt, StylePrompt, TextPrompt
from maua_tpu_torch.text import clip_text as TT
from test_torch_diffusion import TINY_TEXT, port_cfg, random_params

TINY_VISION = JCLIP.CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=4, embed_dim=64)
GRAD_TOL = 1e-4


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= GRAD_TOL * scale, (err, scale)


def _img(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


# ------------------------------------------------------------------ losses
def test_losses_match():
    x, y = _img((2, 12, 10, 5), 0), _img((2, 12, 10, 5), 1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _close(TL.scaled_mse_loss(tx, ty), JL.scaled_mse_loss(x, y))
    _close(TL.feature_loss(tx, ty), JL.feature_loss(x, y))
    _close(TL.tv_loss(tx), JL.tv_loss(x))
    _close(TL.range_loss(tx * 2), JL.range_loss(x * 2))
    a, b = _img((3, 1, 16), 2), _img((1, 4, 16), 3)
    _close(TL.spherical_dist_loss(torch.from_numpy(a), torch.from_numpy(b)), JL.spherical_dist_loss(a, b))


@pytest.mark.parametrize("kw", [{}, {"shift_x": 2, "shift_y": -1}, {"flip_h": True, "flip_v": True},
                                {"use_covariance": True, "shift_x": -3}])
def test_gram_matrix_matches(kw):
    x = _img((2, 9, 11, 6), 4)
    _close(TL.gram_matrix(torch.from_numpy(x), **kw), JL.gram_matrix(x, **kw))


@pytest.mark.parametrize("op", ["normalize", "replace", "clamp"])
def test_custom_gradients_match(op):
    x = _img((2, 5, 4, 3), 5, -2, 2)
    w = _img((2, 5, 4, 3), 6)
    other = _img((2, 5, 4, 3), 7)
    jfn = {"normalize": lambda a: JL.normalize_gradients(a, -3.0),
           "replace": lambda a: JL.replace_grad(jnp.asarray(other), a),
           "clamp": lambda a: JL.clamp_with_grad(a, -1.0, 1.0)}[op]
    tfn = {"normalize": lambda a: TL.normalize_gradients(a, -3.0),
           "replace": lambda a: TL.replace_grad(torch.from_numpy(other), a),
           "clamp": lambda a: TL.clamp_with_grad(a, -1.0, 1.0)}[op]
    want_out, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tfn(tx)
    out.backward(torch.from_numpy(w))
    _close(out, want_out, rtol=0, atol=0)
    _close(tx.grad, want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ cutouts
def jax_cutout_draws(key, h, w, cut_size, n_cuts, cut_pow=1.0):
    """maua_tpu's random_cutouts draws for `key`, as numpy."""
    min_size, max_size = min(h, w, cut_size), min(h, w)
    k1, k2, k3 = jax.random.split(key, 3)
    sizes = jax.random.uniform(k1, (n_cuts,)) ** cut_pow * (max_size - min_size) + min_size
    return (np.asarray(sizes), np.asarray(jax.random.uniform(k2, (n_cuts,)) * (h - sizes)),
            np.asarray(jax.random.uniform(k3, (n_cuts,)) * (w - sizes)))


def clip_grads_draws(key, calls, h, w, cut_size, n_cuts):
    """The draws of maua_tpu's CLIPGrads over `calls` calls: one key split a call."""
    draws = []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        draws.append(jax_cutout_draws(sub, h, w, cut_size, n_cuts))
    return draws


def test_random_cutouts_and_their_gradient_match():
    img = _img((2, 40, 48, 3), 8)
    key = jax.random.PRNGKey(3)
    draws = jax_cutout_draws(key, 40, 48, 16, 5, cut_pow=0.7)
    w = _img((10, 16, 16, 3), 9)
    want, vjp = jax.vjp(lambda im: JC.random_cutouts(key, im, 16, 5, 0.7), jnp.asarray(img))
    timg = torch.from_numpy(img).requires_grad_(True)
    got = TC.random_cutouts(timg, 16, 5, 0.7, draws=draws)
    assert got.shape == (10, 16, 16, 3)
    _close(got, want, rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(w))
    _close(timg.grad, vjp(jnp.asarray(w))[0], rtol=1e-5, atol=1e-5)
    drawn = TC.random_cutouts(torch.from_numpy(img), 16, 5, gen=torch.Generator().manual_seed(0))
    assert drawn.shape == (10, 16, 16, 3) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("kind", ["normal", "maua", "dango"])
def test_cutout_classes_match(kind):
    img = _img((1, 36, 36, 3), 10)
    key = jax.random.PRNGKey(4)
    want = np.asarray(JC.make_cutouts(kind, 16, 6)(jnp.asarray(img), key))
    if kind == "maua":
        k1, k2 = jax.random.split(key)
        draws = [jax_cutout_draws(k1, 36, 36, 16, 3, 3.0), jax_cutout_draws(k2, 36, 36, 16, 3, 0.3)]
    else:
        draws = [jax_cutout_draws(key, 36, 36, 16, 6 - (4 if kind == "dango" else 0))]
    got = TC.make_cutouts(kind, 16, 6)(torch.from_numpy(img), draws=draws)
    _close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ perceptors
@pytest.fixture(scope="module")
def clip_pair():
    vision = random_params(lambda k: JCLIP.init_vision_params(k, TINY_VISION), 20)
    text = random_params(lambda k: JT.init_params(k, TINY_TEXT), 21)
    proj = np.random.RandomState(22).randn(TINY_TEXT.width, TINY_VISION.embed_dim).astype(np.float32) / 8
    jp = JCLIP.CLIPPerceptor(vision_params=vision, vision_cfg=TINY_VISION, text_params=text, text_cfg=TINY_TEXT,
                             text_proj=jnp.asarray(proj))
    tp = TCLIP.CLIPPerceptor(vision_params=bridge.guidance_params_to_torch(vision),
                             vision_cfg=port_cfg(TCLIP.CLIPVisionConfig, TINY_VISION),
                             text_params=bridge.diffusion_params_to_torch(text),
                             text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), text_proj=proj, device="cpu")
    return jp, tp


def test_clip_encoders_match(clip_pair):
    jp, tp = clip_pair
    img = _img((3, 48, 48, 3), 11)  # resized to the tower's 32^2 (bilinear, antialiased)
    want = np.asarray(jp.encode_image(jnp.asarray(img)))
    got = tp.encode_image(torch.from_numpy(img))
    assert got.shape == (3, 64)
    _close(got, want, rtol=1e-4, atol=1e-5)
    texts = ["a red fox in the snow", "", "a lighthouse"]
    _close(tp.encode_text(texts), jp.encode_text(texts), rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.05  # not a degenerate tower


@pytest.mark.parametrize("kind,outputs", [("Aesthetic", 1), ("NIMA", 10)])
def test_clip_heads_match(clip_pair, kind, outputs):
    jp, tp = clip_pair
    rs = np.random.RandomState(27)
    w, b = rs.randn(64, outputs).astype(np.float32) * 0.5, rs.randn(outputs).astype(np.float32) * 0.1
    jhead = getattr(JCLIP, f"{kind}Perceptor")(
        head={"w": jnp.asarray(w), "b": jnp.asarray(b)}, vision_params=jp.vision_params, vision_cfg=TINY_VISION,
        text_params=jp.text_params, text_cfg=TINY_TEXT, text_proj=jp.text_proj)
    thead = getattr(TCLIP, f"{kind}Perceptor")(
        head={"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, vision_params=tp.vision_params,
        vision_cfg=tp.vision_cfg, text_params=tp.text_params, text_cfg=tp.text_cfg, text_proj=tp.text_proj,
        device="cpu")
    img = _img((2, 32, 32, 3), 28)
    _close(thead.score(torch.from_numpy(img)), jhead.score(jnp.asarray(img)), rtol=1e-4, atol=1e-5)


def test_clip_random_towers_and_heads():
    p = TCLIP.CLIPPerceptor(vision_cfg=TCLIP.CLIPVisionConfig(**vars(TINY_VISION)),
                            text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), device="cpu")
    emb = p.encode_image(torch.zeros(1, 32, 32, 3))
    torch.testing.assert_close(emb.norm(dim=-1), torch.ones(1))
    head = TCLIP.NIMAPerceptor(vision_cfg=TCLIP.CLIPVisionConfig(**vars(TINY_VISION)),
                               text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), device="cpu")
    score = head.score(torch.zeros(2, 32, 32, 3))
    assert score.shape == (2,) and bool(((score >= 1) & (score <= 10)).all())
    assert load_perceptor("clip-vit-b32") is TCLIP.CLIPPerceptor
    from maua_tpu_torch.perceptors.pgg import PGGPerceptor

    assert load_perceptor("pgg-vgg19").func is PGGPerceptor


@pytest.fixture(scope="module")
def vgg19_params():
    return random_params(lambda k: JVGG.init_params(k, "vgg19"), 23)


@pytest.mark.parametrize("pool", ["max", "avg", "l2"])
def test_vgg_features_match(vgg19_params, pool):
    img = _img((1, 32, 32, 3), 12)
    want = JVGG.features(vgg19_params, jnp.asarray(img), "vgg19", pool)
    got = TVGG.features(bridge.guidance_params_to_torch(vgg19_params), torch.from_numpy(img), "vgg19", pool)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def _vgg16_state_dict(seed):
    rs = np.random.RandomState(seed)
    idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    chans = (3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    sd = {}
    for n, i in enumerate(idx):
        ci, co = chans[n], chans[n + 1]
        sd[f"features.{i}.weight"] = (rs.randn(co, ci, 3, 3) * math.sqrt(2.0 / (ci * 9))).astype(np.float32)
        sd[f"features.{i}.bias"] = (rs.randn(co) * 0.01).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def lpips_pair():
    vgg_sd = _vgg16_state_dict(24)
    rs = np.random.RandomState(25)
    lin_sd = {f"lin{k}.model.1.weight": (rs.rand(1, c, 1, 1) * 0.1).astype(np.float32)
              for k, c in enumerate(JLP.STAGE_CHANNELS)}
    jparams = JLP.params_from_torch(lin_sd, vgg_sd)
    tparams = TLP.params_from_torch({k: torch.from_numpy(v) for k, v in lin_sd.items()},
                                    {k: torch.from_numpy(v) for k, v in vgg_sd.items()})
    return jparams, tparams


def test_params_from_torch_loaders_match(lpips_pair):
    jparams, tparams = lpips_pair
    back = bridge.guidance_params_to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    jax.tree_util.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0), back, tparams)
    sd = _vgg16_state_dict(26)
    jv = JVGG.params_from_torch(sd, "vgg16")
    tv = TVGG.params_from_torch({k: torch.from_numpy(v) for k, v in sd.items()}, "vgg16")
    assert len(tv) == 13
    jax.tree_util.tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
                           bridge.guidance_params_to_torch(jax.tree_util.tree_map(np.asarray, jv)), tv)


def test_lpips_matches(lpips_pair):
    jparams, tparams = lpips_pair
    a, b = _img((2, 32, 32, 3), 13), _img((2, 32, 32, 3), 14)
    want = np.asarray(JLP.lpips(jparams, jnp.asarray(a), jnp.asarray(b)))
    got = TLP.lpips(tparams, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2,) and (want > 0).all()
    _close(got, want, rtol=1e-4, atol=0)
    assert float(TLP.lpips(tparams, torch.from_numpy(a), torch.from_numpy(a)).abs().max()) < 1e-6


# ------------------------------------------------------------------ grad modules
def _prompts(texts=("a red fox",), style_seed=15, content_seed=16, size=32):
    style = _img((1, size, size, 3), style_seed, 0.0, 1.0)
    content = _img((1, size, size, 3), content_seed, 0.0, 1.0)
    j = [JTextPrompt(t) for t in texts] + [JStylePrompt(img=style), JContentPrompt(img=content)]
    t = [TextPrompt(t) for t in texts] + [StylePrompt(img=style), ContentPrompt(img=content)]
    return j, t


def _module_grads(jm, tm, img, prompts_pair, calls=1, close=_grad_close):
    jprompts, tprompts = prompts_pair
    jm.set_targets(jprompts)
    tm.set_targets(tprompts)
    for _ in range(calls):
        want = jm(jnp.asarray(img), 0)
        got = tm(torch.from_numpy(img), 0)
        assert got.shape == img.shape
        close(got, want)


def _l2_close(got, want, rtol=1e-2):
    want = np.asarray(want)
    err = np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)
    assert err <= rtol, err


@pytest.mark.parametrize("name", ["color", "color_on_device", "range", "tv"])
def test_simple_grad_modules_match(name):
    img = _img((1, 24, 24, 3), 17, -1.3, 1.3)
    jm, tm = {"color": (JG.ColorMatchGrads(2.0, bins=16), TG.ColorMatchGrads(2.0, bins=16)),
              "color_on_device": (JG.ColorMatchGrads(2.0, bins=16), TG.ColorMatchGrads(2.0, bins=16, device="cpu")),
              "range": (JG.RangeGrads(3.0), TG.RangeGrads(3.0)),
              "tv": (JG.TVGrads(0.5), TG.TVGrads(0.5))}[name]
    _module_grads(jm, tm, img, _prompts(size=24))


def test_color_match_builds_its_target_where_asked():
    """With a device, set_targets builds the target histogram there; without one, the first call builds it
    on the image's device. A later set_targets without a style image keeps the target."""
    _, tprompts = _prompts(size=24)
    img = torch.from_numpy(_img((1, 24, 24, 3), 17, -1.3, 1.3))
    eager, lazy = TG.ColorMatchGrads(2.0, bins=16, device="cpu"), TG.ColorMatchGrads(2.0, bins=16)
    for gm in (eager, lazy):
        gm.set_targets(tprompts)
    assert eager.target_hist is not None and eager.target_hist.device == torch.device("cpu")
    assert lazy.target_hist is None
    assert torch.equal(lazy(img, 0), eager(img, 0)) and lazy.target_hist.device == img.device
    eager.set_targets([TextPrompt("a fox")])
    assert eager.target_hist is not None


def test_differentiable_histogram_matches():
    x = _img((2, 8, 8, 3), 18, 0.0, 1.0)
    _close(TG.differentiable_histogram(torch.from_numpy(x), 12), JG.differentiable_histogram(jnp.asarray(x), 12),
           rtol=1e-5, atol=1e-5)


def test_clip_grads_match_call_by_call(clip_pair):
    jp, tp = clip_pair
    key = jax.random.PRNGKey(9)
    img = _img((1, 48, 40, 3), 19)
    jm = JG.CLIPGrads(perceptor=jp, scale=5.0, n_cutouts=6, cutout_key=key)
    tm = TG.CLIPGrads(perceptor=tp, scale=5.0, n_cutouts=6, draws=clip_grads_draws(key, 2, 48, 40, 32, 6))
    jprompts, tprompts = _prompts(texts=("a red fox:2", "snow:-0.5"))
    jprompts.append(JG.ImagePrompt(img=_img((1, 32, 32, 3), 20, 0.0, 1.0)))
    tprompts.append(TG.ImagePrompt(img=_img((1, 32, 32, 3), 20, 0.0, 1.0)))
    _module_grads(jm, tm, img, (jprompts, tprompts), calls=2)
    assert tm.draws == []  # one draw a call
    drawn = TG.CLIPGrads(perceptor=tp, n_cutouts=4)
    drawn.set_targets(tprompts)
    assert drawn(torch.from_numpy(img), 0).abs().max() > 0


@pytest.mark.parametrize("name", ["vgg", "content"])
def test_vgg_grad_modules_match(vgg19_params, name):
    img = _img((1, 32, 32, 3), 21)
    jper = JVGG.VGGPerceptor(params=vgg19_params)
    tper = TVGG.VGGPerceptor(params=bridge.guidance_params_to_torch(vgg19_params), device="cpu")
    cls = {"vgg": (JG.VGGGrads, TG.VGGGrads), "content": (JG.ContentGrads, TG.ContentGrads)}[name]
    _module_grads(cls[0](perceptor=jper, scale=2.0), cls[1](perceptor=tper, scale=2.0), img, _prompts())


def test_lpips_grads_match(lpips_pair):
    jparams, tparams = lpips_pair
    img = _img((1, 48, 48, 3), 22)
    _module_grads(JG.LPIPSGrads(scale=3.0, params=jparams), TG.LPIPSGrads(scale=3.0, params=tparams, device="cpu"),
                  img, _prompts(size=48), close=_l2_close)


def test_ssim_and_latent_ssim_grads_match():
    x, y = _img((1, 20, 20, 4), 23, -3, 3), _img((1, 20, 20, 4), 24, -3, 3)
    _close(TG.ssim(torch.from_numpy(x), torch.from_numpy(y)), JG.ssim(jnp.asarray(x), jnp.asarray(y)), rtol=1e-5)

    def jenc(im):
        return jnp.tile(jnp.asarray(im)[..., :1], (1, 1, 1, 4)) * 5.0

    def tenc(im):
        return im[..., :1].repeat(1, 1, 1, 4) * 5.0

    _module_grads(JG.LatentSSIMGrads(2.0, jenc), TG.LatentSSIMGrads(2.0, tenc), x, _prompts(size=20))


def test_modules_without_targets_give_zeros():
    img = torch.ones(1, 8, 8, 3)
    for gm in (TG.ColorMatchGrads(), TG.LPIPSGrads(device="cpu"), TG.LatentSSIMGrads()):
        assert torch.equal(gm(img, 0), torch.zeros_like(img))


# ------------------------------------------------------------------ guided_denoiser
def test_guided_denoiser_matches():
    """An analytic model and cond_fn in both frameworks: the vjp goes back through the model."""
    x = _img((2, 3, 6, 6), 25)
    sigma = np.array([3.0, 0.5], np.float32)
    w = _img((2, 3, 6, 6), 26)

    def jmodel(xx, s):
        return jnp.tanh(xx) * s[:, None, None, None] + xx**2 * 0.1

    def jcond(xx, s, den, vjp):
        (g,) = vjp(jnp.sin(den) * jnp.asarray(w))
        return -g

    def tmodel(xx, s):
        return torch.tanh(xx) * s[:, None, None, None] + xx**2 * 0.1

    def tcond(xx, s, den, vjp):
        (g,) = vjp(torch.sin(den.detach()) * torch.from_numpy(w))
        return -g

    want = JW.guided_denoiser(jmodel, jcond)(jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = TW.guided_denoiser(tmodel, tcond)(torch.from_numpy(x), torch.from_numpy(sigma))
    assert got.grad_fn is None
    _close(got, want, rtol=1e-5, atol=1e-5)

"""The port's serving layer (maua_tpu_torch/serve.py) against maua_tpu's, on the CPU.

The micro-batcher cases of tests/test_serve.py run against the port's
batcher. The GAN service: a 32^2 StyleGAN2 (tests/test_serve.py's config)
with maua_tpu's seed-0 parameters brought over by the bridge, served by both
packages on the same seeds and truncations: frames within one uint8 level.
The diffusion service: a tiny SD at 32^2 with numpy-drawn parameters, JAX's
per-seed noise handed to the port's batch function: frames within one uint8
level of maua_tpu's jitted text2img. Then the HTTP routes and their errors.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from maua_tpu import serve as JSV
from maua_tpu import utility as jax_utility
from maua_tpu.diffusion.models import unet as JU
from maua_tpu.diffusion.models import vae as JV
from maua_tpu.diffusion.processors.stable import StableDiffusion as JaxSD
from maua_tpu.gan import stylegan2 as JG
from maua_tpu.gan import wrappers as JGW
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch import serve as SV
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.gan import stylegan2 as TG
from maua_tpu_torch.gan import wrappers as TGW
from maua_tpu_torch.parallel.mesh import make_mesh
from maua_tpu_torch.text import clip_text as TT
from test_torch_diffusion import TINY_TEXT, TINY_UNET, TINY_VAE, port_cfg, random_params

torch.set_num_threads(1)

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
GAN_KW = dict(img_resolution=32, z_dim=16, w_dim=16, channel_base=1024, channel_max=32, num_fp16_res=0)
REQUESTS = [{"seed": 3}, {"seed": 4, "truncation": 0.7}, {"seed": 5, "truncation": 0.5}, {"seed": 3}]
LEVEL = 1  # uint8 levels: f32 synthesis in another summation order, cast after the clip


# ------------------------------------------------------------------ the batcher
def test_microbatcher_coalesces_and_routes():
    calls = []

    def run(batch):
        assert batch["x"].shape[0] == 4  # every call sees exactly max_batch rows
        calls.append(batch["x"].copy())
        time.sleep(0.05)  # a device step, so that later submits queue up
        return batch["x"] * 2.0

    mb = SV.MicroBatcher(run, max_batch=4, max_wait_ms=40.0)
    futs = [mb.submit({"x": np.full((1, 3), float(i))}) for i in range(6)]
    for i, f in enumerate(futs):
        assert np.allclose(f.result(timeout=10), 2.0 * i)
    mb.close()
    assert len(calls) == 2  # 4 + 2 padded
    snap = mb.metrics.snapshot()
    assert snap["served"] == 6 and snap["batches"] == 2 and snap["max_occupancy"] == 4 and snap["errors"] == 0
    assert snap["p50_ms"] is not None


def test_microbatcher_propagates_errors():
    def run(batch):
        raise ValueError("boom")

    mb = SV.MicroBatcher(run, max_batch=2, max_wait_ms=1.0)
    with pytest.raises(ValueError, match="boom"):
        mb.submit({"x": np.zeros((1,))}).result(timeout=10)
    mb.close()
    assert mb.metrics.snapshot()["errors"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit({"x": np.zeros((1,))})


def test_microbatcher_close_flushes_pending():
    mb = SV.MicroBatcher(lambda b: b["x"] + 1.0, max_batch=8, max_wait_ms=5000.0)
    fut = mb.submit({"x": np.zeros((1, 2))})
    mb.close()  # runs the waiting partial batch
    assert np.allclose(fut.result(timeout=10), 1.0)


def test_microbatcher_dict_outputs_and_metrics_match_maua_tpus():
    mb = SV.MicroBatcher(lambda b: {"a": b["x"], "b": -b["x"]}, max_batch=2, max_wait_ms=1.0)
    row = mb.submit({"x": np.ones((1, 3))}).result(timeout=10)
    mb.close()
    assert set(row) == {"a", "b"} and np.array_equal(row["b"], -np.ones(3))
    got, want = SV.ServiceMetrics(), JSV.ServiceMetrics()
    for ms in [1, 2, 3, 4, 100]:
        got.record_request(ms / 1e3)
        want.record_request(ms / 1e3)
    got.record_batch(3)
    want.record_batch(3)
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["p50_ms"] == pytest.approx(3.0, abs=0.5) and got.snapshot()["p95_ms"] > 50


# ------------------------------------------------------------------ GAN
@pytest.fixture(scope="module")
def gan(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_utility, "WORKSPACE", str(tmp_path_factory.mktemp("ws")))  # maua_tpu caches s2d plans there
        jgen = JGW.StyleGAN2(cfg=JG.SG2Config(**GAN_KW))
        jsvc = JSV.GANImageService(generator=jgen, max_batch=4, max_wait_ms=100.0)
        want = [f.result(timeout=300) for f in [jsvc.submit(r) for r in REQUESTS]]
        jsvc.close()
    tgen = TGW.StyleGAN2(cfg=TG.SG2Config(**GAN_KW), params=bridge.params_to_torch(jax.device_get(jgen.params)),
                         device="cpu")
    svc = SV.GANImageService(generator=tgen, max_batch=4, max_wait_ms=100.0)
    yield {"svc": svc, "gen": tgen, "want": want}
    svc.close()


def test_gan_service_matches_maua_tpus(gan):
    svc = gan["svc"]
    got = [f.result(timeout=120) for f in [svc.submit(r) for r in REQUESTS]]
    for r, a, b in zip(REQUESTS, got, gan["want"]):
        assert a.shape == (32, 32, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= LEVEL and (d == 0).mean() > 0.95, (r, d.max(), (d == 0).mean())
    assert np.array_equal(got[0], got[3]) and not np.array_equal(got[0], got[1])
    assert svc.metrics.snapshot()["max_occupancy"] >= 2


def test_gan_service_takes_a_z_and_renders_png(gan):
    svc = gan["svc"]
    z = np.random.RandomState(3).randn(16).astype(np.float32)
    a = svc.submit({"z": z.tolist()}).result(timeout=120)
    b = svc.submit({"seed": 3}).result(timeout=120)
    assert np.array_equal(a, b)  # the seed's z is numpy's RandomState draw, as in maua_tpu
    png = svc.render_png({"seed": 0})
    assert png.startswith(PNG_MAGIC) and np.array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                                         svc.submit({"seed": 0}).result(timeout=120))


def test_gan_batches_run_without_autograd_on_the_worker(gan):
    """Grad mode is thread-local: the worker enters inference mode itself, so the kernels launch bare."""
    seen = []
    gen = gan["gen"]
    synth = gen.synthesizer

    def spy(ws, **kw):
        seen.append((threading.current_thread().name, torch.is_grad_enabled(), torch.is_inference_mode_enabled()))
        out = synth(ws, **kw)
        seen.append(out.is_inference())
        return out

    gen.synthesizer = spy
    try:
        gan["svc"].submit({"seed": 1}).result(timeout=120)
    finally:
        gen.synthesizer = synth
    assert seen == [("maua-microbatch", False, True), True]


def test_gan_service_on_a_mesh_matches_the_unsharded_service(gan):
    svc = SV.GANImageService(generator=gan["gen"], max_batch=6, max_wait_ms=100.0,
                             mesh=make_mesh(4, shape=(4, 1), devices=["cpu"] * 4))
    try:
        assert svc._batcher.max_batch == 4  # rounded down to a multiple of the data axis
        got = [f.result(timeout=120) for f in [svc.submit(r) for r in REQUESTS]]
    finally:
        svc.close()
    want = [f.result(timeout=120) for f in [gan["svc"].submit(r) for r in REQUESTS]]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_http_routes_and_errors(gan):
    server = SV.make_http_server({"gan": gan["svc"]}, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    try:
        with post("/v1/gan", json.dumps({"seed": 7, "truncation": 0.9}).encode()) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"] == "image/png"
            assert resp.read().startswith(PNG_MAGIC)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["gan"]["served"] >= 1
        for path, body, code in (("/v1/nope", b"{}", 404), ("/v1/gan", b"{not json", 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                post(path, body)
            assert err.value.code == code
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/elsewhere", timeout=30)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_main_builds_the_services_it_is_asked_for(monkeypatch, gan):
    tiny = lambda architecture: (lambda model_file=None, device=None: gan["gen"])  # noqa: E731
    monkeypatch.setattr(TGW, "get_generator_class", tiny)
    args = type("A", (), dict(artifact=None, model_file=None, architecture="stylegan2", max_batch=2, max_wait_ms=5.0,
                              upscale_model=None, diffusion=False, warmup=True, device="cpu"))
    services = SV.build_services(args)
    try:
        assert sorted(services) == ["gan"] and services["gan"].metrics.snapshot()["served"] == 1  # the warmup
    finally:
        for svc in services.values():
            svc.close()


# ------------------------------------------------------------------ diffusion
@pytest.fixture(scope="module")
def sd():
    unet = random_params(lambda k: JU.init_params(k, TINY_UNET), 0)
    vae = random_params(lambda k: JV.init_params(k, TINY_VAE), 1)
    text = jax.tree_util.tree_map(jax.numpy.asarray, random_params(lambda k: JT.init_params(k, TINY_TEXT), 2))
    kw = dict(sampler="euler", timesteps=3, cfg_scale=5.0, image_size=32)
    jsd = JaxSD(unet_params=unet, vae_params=vae, text_params=text, unet_cfg=TINY_UNET, vae_cfg=TINY_VAE,
                text_cfg=TINY_TEXT, **kw)
    tsd = StableDiffusion(unet_params=bridge.diffusion_params_to_torch(unet),
                          vae_params=bridge.diffusion_params_to_torch(vae),
                          text_params=bridge.diffusion_params_to_torch(jax.device_get(text)),
                          unet_cfg=port_cfg(TU.UNetConfig, TINY_UNET), vae_cfg=port_cfg(TV.VAEConfig, TINY_VAE),
                          text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), device="cpu", **kw)
    tokens = np.asarray(JT.tokenize(["a red boat", "a blue cube"], TINY_TEXT.context_length), np.int32)
    seeds = np.asarray([1, 2], np.uint32)
    scales = np.asarray([5.0, 2.0], np.float32)
    want = np.asarray(jax.jit(JSV.text2img_fn(jsd))(tokens, seeds, scales))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(int(s)), (16, 16, 4))) for s in seeds])
    return {"tsd": tsd, "tokens": tokens, "seeds": seeds, "scales": scales, "want": want, "noise": noise}


def test_text2img_matches_maua_tpu_with_its_noise(sd):
    got = SV.text2img_fn(sd["tsd"])(sd["tokens"], sd["seeds"], sd["scales"], noise=sd["noise"]).numpy()
    assert got.shape == sd["want"].shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - sd["want"].astype(int)).max() <= LEVEL
    assert np.array_equal(SV.text2img_fn(sd["tsd"])(sd["tokens"], sd["seeds"], sd["scales"]),
                          SV.text2img_fn(sd["tsd"])(sd["tokens"], sd["seeds"], sd["scales"],
                                                    noise=SV.seeded_noise(sd["tsd"], sd["seeds"], "cpu")
                                                    .permute(0, 2, 3, 1)))


def test_diffusion_service_images_are_fixed_by_text_and_seed(sd):
    svc = SV.DiffusionImageService(processor=sd["tsd"], max_batch=3, max_wait_ms=200.0)
    try:
        futs = [svc.submit({"text": "a red boat", "seed": 1}), svc.submit({"text": "a blue cube", "seed": 2}),
                svc.submit({"text": "a red boat", "seed": 1, "cfg_scale": 2.0})]
        a, b, c = [f.result(timeout=300) for f in futs]
        alone = svc.submit({"text": "a red boat", "seed": 1}).result(timeout=300)
        assert svc.metrics.snapshot()["max_occupancy"] == 3
        assert np.array_equal(a, alone)  # co-batched or alone, the same image
        assert not np.array_equal(a, b) and not np.array_equal(a, c)
        assert svc.render_png({"text": "x", "seed": 0}).startswith(PNG_MAGIC)
    finally:
        svc.close()


# ------------------------------------------------------------------ upscale
def test_upscale_service_matches_its_upscaler():
    from maua_tpu_torch.super.image import Upscaler

    up = Upscaler("waifu2x-anime-noise0", device="cpu")
    svc = SV.UpscaleService(upscaler=up)
    try:
        img = (np.random.RandomState(0).rand(12, 10, 3) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        payload = {"image": base64.b64encode(buf.getvalue()).decode()}
        out = svc.submit(payload).result(timeout=300)
        want = (np.clip(up(img[None].astype(np.float32) / 255.0).numpy()[0], 0, 1) * 255.0).astype(np.uint8)
        assert out.shape == (12 * up.scale, 10 * up.scale, 3) and np.array_equal(out, want)
        assert svc.render_png(payload).startswith(PNG_MAGIC)
    finally:
        svc.close()

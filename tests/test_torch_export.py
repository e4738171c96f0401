"""The port's torch.export artifacts (maua_tpu_torch/export.py), on the CPU.

Round trips of a plain function, of a 32^2 StyleGAN2's frames program (the
service's generator) and of a tiny SD's text -> image program; the graphs
call the kernels' custom ops (on the CPU each runs its plain version), so on
the card the artifact launches the hand-written kernels. The artifact's
metadata keeps maua_tpu's `in_avals` form, which `ArtifactGANService`
parses. A fresh process loads an artifact importing no model module and
nothing of JAX. Tolerance: exact (the program replays the eager ops).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from maua_tpu_torch import export as EX
from maua_tpu_torch import serve as SV
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.diffusion.models import vae as TV
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.gan import stylegan2 as TG
from maua_tpu_torch.gan import wrappers as TGW
from maua_tpu_torch.text import clip_text as TT

torch.set_num_threads(1)

GAN_KW = dict(img_resolution=32, z_dim=16, w_dim=16, channel_base=1024, channel_max=32, num_fp16_res=0)


def op_calls(path, name):
    """How many nodes of an artifact's graph call the custom op maua_tpu_torch::<name>."""
    graph = torch.export.load(path).graph
    return sum(1 for n in graph.nodes if n.op == "call_function" and f"maua_tpu_torch.{name}" in str(n.target))


@pytest.fixture(scope="module")
def gen():
    return TGW.StyleGAN2(cfg=TG.SG2Config(**GAN_KW), device="cpu", seed=3)


@pytest.fixture(scope="module")
def gan_artifact(gen, tmp_path_factory):
    return EX.export_generator(gen, str(tmp_path_factory.mktemp("gan") / "g.pt2"), batch_size=4)


def test_export_fn_round_trip(tmp_path):
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))

    def fn(x):
        return torch.tanh(x @ w)  # w baked in as a constant

    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(1))
    path = EX.export_fn(fn, (x,), str(tmp_path / "fn.pt2"))
    meta = EX.exported_meta(path)
    assert meta["in_avals"] == ["float32[2,4]"] and meta["out_avals"] == ["float32[2,3]"]
    torch.testing.assert_close(EX.load_exported(path)(x.numpy()), fn(x), rtol=0, atol=0)


@pytest.fixture(scope="module")
def baked_artifact(gen, tmp_path_factory):
    return EX.export_generator(gen, str(tmp_path_factory.mktemp("baked") / "g.pt2"), batch_size=2, truncation=0.8)


def test_export_generator_with_truncation_baked_in(gen, baked_artifact):
    path = baked_artifact
    assert EX.exported_meta(path)["in_avals"] == ["float32[2,16]"]
    z = np.random.RandomState(0).randn(2, 16).astype(np.float32)
    with torch.no_grad():
        direct = SV.to_u8(gen.synthesizer(gen.mapper(torch.from_numpy(z), truncation=0.8)))
    got = EX.load_exported(path)(z)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.uint8
    torch.testing.assert_close(got, direct, rtol=0, atol=0)


def test_generator_graph_calls_the_epilogue_op(gan_artifact):
    # one epilogue after each synthesis conv: b4 conv1, two in each of b8, b16, b32
    assert op_calls(gan_artifact, "modconv_epilogue") == 7
    meta = EX.exported_meta(gan_artifact)
    assert meta["in_avals"] == ["float32[4,16]", "float32[4]"] and meta["out_avals"] == ["uint8[4,32,32,3]"]


def test_artifact_service_matches_the_live_service(gen, gan_artifact):
    live = SV.GANImageService(generator=gen, max_batch=4, max_wait_ms=10.0)
    art = SV.ArtifactGANService(gan_artifact, max_wait_ms=10.0)
    try:
        assert art.z_dim == 16 and art._batcher.max_batch == 4  # from the signature
        for payload in ({"seed": 3}, {"seed": 5, "truncation": 0.6}):
            assert np.array_equal(art.submit(payload).result(timeout=300), live.submit(payload).result(timeout=300))
    finally:
        live.close()
        art.close()


def test_artifact_service_refuses_a_baked_truncation(baked_artifact):
    with pytest.raises(ValueError, match="signature"):
        SV.ArtifactGANService(baked_artifact)


def test_artifact_loads_in_a_process_without_model_code(gan_artifact):
    """The deployment contract: a fresh process that imports no model module (and no JAX) replays the
    artifact through the kernels' ops."""
    script = f"""
import sys
import numpy as np
from maua_tpu_torch.export import load_exported
out = load_exported({gan_artifact!r})(np.zeros((4, 16), np.float32), np.ones((4,), np.float32))
assert tuple(out.shape) == (4, 32, 32, 3) and str(out.dtype) == "torch.uint8"
models = [m for m in sys.modules if m.startswith(("maua_tpu_torch.gan", "maua_tpu_torch.diffusion", "jax", "maua_tpu."))
          or m == "maua_tpu"]
print("ARTIFACT_OK", models)
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert "ARTIFACT_OK []" in r.stdout, r.stdout + r.stderr[-1500:]


@pytest.fixture(scope="module")
def sd():
    # 32^2: the VAE's mid attention is (2, 1, 256, 32), on the kernel route
    return StableDiffusion(
        sampler="euler", timesteps=2, image_size=32, device="cpu",
        unet_cfg=TU.UNetConfig(in_channels=4, out_channels=4, model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                               attention_resolutions=(2,), num_heads=2, context_dim=16, transformer_depth=1),
        vae_cfg=TV.VAEConfig(base_channels=8, channel_mult=(1, 2), num_res_blocks=1, z_channels=4),
        text_cfg=TT.CLIPTextConfig(width=16, layers=1, heads=2, context_length=8))


def test_export_diffusion_round_trip(sd, tmp_path):
    path = EX.export_diffusion(sd, str(tmp_path / "sd.pt2"), batch_size=2)
    assert EX.exported_meta(path)["in_avals"] == ["int64[2,8]", "float32[2,16,16,4]", "float32[2]"]
    assert op_calls(path, "flash_attention") == 1  # the decode's mid attention
    tokens = np.asarray(TT.tokenize(["a red boat", "a blue cube"], 8), np.int64)
    seeds, scales = [1, 2], np.asarray([7.5, 2.0], np.float32)
    noise = SV.seeded_noise(sd, seeds, "cpu").permute(0, 2, 3, 1)
    got = EX.load_exported(path)(tokens, noise, scales)
    torch.testing.assert_close(got, SV.text2img_fn(sd)(tokens, seeds, scales), rtol=0, atol=0)


def test_export_diffusion_refuses_ancestral_samplers(sd, tmp_path, monkeypatch):
    monkeypatch.setattr(sd, "sampler_name", "euler_ancestral")
    with pytest.raises(ValueError, match="ancestral"):
        EX.export_diffusion(sd, str(tmp_path / "a.pt2"))

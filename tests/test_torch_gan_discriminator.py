"""The port's StyleGAN2 discriminator (`maua_tpu_torch/gan/discriminator.py`), its loaders
(`gan/load.py`) and the discriminator Langevin energy (`gan/sampling.py`) against maua_tpu.

Inputs and parameters are numpy draws from seeds, carried across by
`bridge.d_params_to_torch`. Tolerances, of each output's largest magnitude:
f32 1e-4 (the same convs summed in other orders); bf16 1e-2, the port's and
JAX's bf16 convs rounding their products and sums differently over seven
layers (read 4.8e-3 at 32^2, where either side lies ~2e-2 from the f32 logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from maua_tpu.gan import discriminator as JD
from maua_tpu.gan import load as JL
from maua_tpu.gan import sampling as JS
from maua_tpu.gan import stylegan2 as JG
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import discriminator as TD
from maua_tpu_torch.gan import load as TL
from maua_tpu_torch.gan import sampling as TS
from maua_tpu_torch.gan import stylegan2 as TG
from maua_tpu_torch.gan import wrappers as TW
from test_torch_stylegan2 import random_jax_params

torch.set_num_threads(1)

D_KW = dict(img_resolution=32, channel_base=256, channel_max=32)
G_KW = dict(img_resolution=16, z_dim=16, w_dim=16, channel_base=128, channel_max=16, mapping_layers=2,
            num_fp16_res=0)


def random_jax_d_params(cfg, seed):
    """maua_tpu's discriminator tree (init_params' shapes, traced abstractly) filled from numpy, with
    nonzero biases."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: JD.init_params(jax.random.PRNGKey(0), cfg))

    def fill(path, leaf):
        a = rs.randn(*leaf.shape).astype(np.float32)
        return a * np.float32(0.1) if path[-1].key in ("b", "bias") else a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def images(seed, b, res, c=3):
    return np.tanh(np.random.RandomState(seed).randn(b, res, res, c)).astype(np.float32)


@pytest.fixture(scope="module")
def d_net():
    cfg = JD.D2Config(**D_KW)
    return cfg, random_jax_d_params(cfg, 3)


def test_bridge_round_trips_the_discriminator(d_net):
    cfg, jp = d_net
    tp = bridge.d_params_to_torch(jp)
    assert tuple(tp["b4"]["fc"]["w"].shape) == (32, 32 * 16)
    back = bridge.d_params_to_jax(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_discriminator_matches_maua_tpu(d_net, dtype, tol):
    cfg, jp = d_net
    cfg = JD.D2Config(**D_KW, dtype=dtype)
    x = images(0, 4, 32)
    want = np.asarray(jax.jit(lambda p, i: JD.discriminator(p, i, cfg))(jp, jnp.asarray(x)))
    got = TD.discriminator(bridge.d_params_to_torch(jp), torch.from_numpy(x).permute(0, 3, 1, 2),
                           TD.D2Config(**D_KW, dtype=dtype))
    assert got.shape == (4, 1) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < tol


@pytest.mark.parametrize("batch,group", [(3, 4), (5, 4), (6, 4), (4, 2), (7, 3)])
def test_minibatch_stddev_matches_maua_tpu(batch, group):
    x = np.random.RandomState(batch).randn(batch, 4, 4, 6).astype(np.float32)
    want = np.asarray(JD.minibatch_stddev(jnp.asarray(x), group, 2))
    got = TD.minibatch_stddev(torch.from_numpy(x).permute(0, 3, 1, 2), group, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-6)


def test_init_params_shapes_match_maua_tpu():
    cfg = JD.D2Config(**D_KW)
    want = bridge.d_params_to_torch(random_jax_d_params(cfg, 0))
    got = TD.init_params(TD.D2Config(**D_KW), torch.Generator().manual_seed(0))
    flat = lambda t: {k: v.shape for k, v in chip_smoke.ada_state_dict(t).items()}  # noqa: E731
    assert flat(got) == flat(want)


def _ada_d(cfg, seed):
    """A synthetic ADA discriminator state dict from the port's params, and those params."""
    tp = TD.init_params(TD.D2Config(**D_KW), torch.Generator().manual_seed(seed))
    tp = {k: {kk: ({n: t + 0.01 * (i + 1) for i, (n, t) in enumerate(vv.items())} if isinstance(vv, dict) else vv)
              for kk, vv in v.items()} for k, v in tp.items()}
    return chip_smoke.ada_d_state_dict(tp, cfg), tp


@pytest.mark.parametrize("fmt", ["pkl", "pt", "pt_bare"])
def test_load_discriminator_matches_maua_tpu(tmp_path, fmt):
    cfg = TD.D2Config(**D_KW)
    sd, tp = _ada_d(cfg, 1)
    g_sd = chip_smoke.ada_state_dict(TG.init_params(TG.SG2Config(**G_KW), torch.Generator().manual_seed(0)))
    path = str(tmp_path / f"net.{fmt.split('_')[0]}")
    if fmt == "pkl":
        chip_smoke.write_ada_pkl(path, g_sd, sd)
    elif fmt == "pt":
        torch.save({"G_ema": g_sd, "D": sd}, path)
    else:
        torch.save(sd, path)
    got, got_cfg = TL.load_discriminator(path)
    want, want_cfg = JL.load_discriminator(path)
    assert TD.D2Config(**{f: getattr(want_cfg, f) for f in TD.D2Config.__dataclass_fields__}) == got_cfg == cfg
    np_sd = {k: v.numpy() for k, v in sd.items()}
    assert JL.infer_d_config(np_sd) == want_cfg and TL.infer_d_config(np_sd) == got_cfg
    assert chip_smoke.assert_trees_equal(got, tp, "loaded D") > 0
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(want)),
                    jax.tree_util.tree_leaves(bridge.d_params_to_jax(got))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_discriminator_refuses_a_pkl_without_d(tmp_path):
    path = str(tmp_path / "g.pkl")
    chip_smoke.write_ada_pkl(path, chip_smoke.ada_state_dict(
        TG.init_params(TG.SG2Config(**G_KW), torch.Generator().manual_seed(0))))
    with pytest.raises(ValueError, match="discriminator"):
        TL.load_discriminator(path)


def test_discriminator_energy_matches_maua_tpu(d_net):
    """E(z) = -D(G(z)) with the 16^2 image resized bilinearly to D's 32^2, and its gradient."""
    g_cfg = JG.SG2Config(**G_KW)
    gp = random_jax_params(g_cfg, 2)
    d_cfg, dp = d_net
    z = np.random.RandomState(5).randn(3, 16).astype(np.float32)
    jgen = JG.Generator(g_cfg, params=gp)
    j_energy = JS.discriminator_energy(jgen, dp, d_cfg)
    energy_and_grad = jax.jit(jax.value_and_grad(lambda zz: (j_energy(zz).sum(), j_energy(zz)), has_aux=True))
    (_, want_e), want_g = energy_and_grad(jnp.asarray(z))
    want_e, want_g = np.asarray(want_e), np.asarray(want_g)
    tgen = TG.Generator(TG.SG2Config(**G_KW), params=bridge.params_to_torch(gp))
    t_energy = TS.discriminator_energy(tgen, bridge.d_params_to_torch(dp), TD.D2Config(**D_KW))
    zz = torch.from_numpy(z).requires_grad_(True)
    e = t_energy(zz)
    (g,) = torch.autograd.grad(e.sum(), zz)
    assert rel_err(e.detach().numpy(), want_e) < 1e-4
    assert rel_err(g.numpy(), want_g) < 1e-4


def test_langevin_critic_discriminator_reads_the_checkpoints_d(tmp_path):
    """`--langevin_critic discriminator` on a .pkl with a D: the facade keeps its model_file, the energy
    is D's, and the samples follow from the same draws as with that energy handed in."""
    g_cfg = TG.SG2Config(**G_KW)
    sd, tp = _ada_d(TD.D2Config(**D_KW), 4)
    path = str(tmp_path / "net.pkl")
    chip_smoke.write_ada_pkl(path, chip_smoke.ada_state_dict(TG.init_params(g_cfg, torch.Generator().manual_seed(0))),
                             sd)
    gan = TW.StyleGAN2(model_file=path, dtype="float32", device="cpu")
    assert gan.model_file == path
    z0 = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    noise = torch.randn(3, 2, 16, generator=torch.Generator().manual_seed(2))
    got = TS.sample_latents("langevin", None, 2, gan.params, gan.cfg, generator=gan, critic="discriminator",
                            n_steps=3, z=z0, noise=noise)
    energy = TS.discriminator_energy(gan, tp, TD.D2Config(**D_KW))
    want = TS.langevin_sample(None, 2, energy, 16, n_steps=3, z=z0, noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float((got - z0).abs().max()) > 0
    with pytest.raises(ValueError, match="checkpoint"):
        TS.make_langevin_energy(TW.StyleGAN2(cfg=g_cfg, dtype="float32", device="cpu"), "discriminator")

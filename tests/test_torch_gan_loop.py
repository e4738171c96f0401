"""The port's GAN fit loop and checkpoints (`maua_tpu_torch/gan/train_loop.py`), the training
CLI (`gan/train_cli.py`) and the experimental families (`gan/models_experimental.py`) against
maua_tpu's.

The experimental families' parameters take the structure of maua_tpu's own
init (its `jax.eval_shape`, nothing compiled), filled from a numpy seed with
nonzero biases and gains off 1, and carried across by
`bridge.experimental_params_to_torch`; their outputs agree within 1e-4 of the
largest magnitude (f32 convs and matmuls summed in other orders). The CLI is compared by the configurations both packages build
from the same flags (their `fit` and data stages stubbed). The fit, the
checkpoints and the resume run on the port alone, at 16^2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_tpu.gan import models_experimental as JE
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import discriminator as TD
from maua_tpu_torch.gan import models_experimental as TE
from maua_tpu_torch.gan import stylegan2 as TG
from maua_tpu_torch.gan import train_cli as TC
from maua_tpu_torch.gan import train_loop as TL
from maua_tpu_torch.gan import training as TT
from maua_tpu_torch.utility import to_device

torch.set_num_threads(1)

G_KW = dict(img_resolution=16, z_dim=16, w_dim=16, channel_base=128, channel_max=16, mapping_layers=2,
            num_fp16_res=0)
D_KW = dict(img_resolution=16, channel_base=128, channel_max=16)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ----------------------------------------------------- experimental families
FAMILIES = {  # name: (G init, G forward, D init, D forward, G args, D args, resolution, z_dim)
    "dcgan": ("init_dcgan_g", "dcgan_g", "init_dcgan_d", "dcgan_d", (8, 8, 16), (8, 16), 16, 8),
    "hypermixer": ("init_hypermixer_g", "hypermixer_g", "init_dcgan_d", "dcgan_d", (8, 16, 8, 2, 16), (4, 16), 16, 8),
    "involution": ("init_involution_g", "involution_g", "init_involution_d", "involution_d", (8, 4, 8), (4, 8), 8, 8),
    "steerable": ("init_steerable_g", "steerable_g", "init_steerable_d", "steerable_d", (8, 4, 16, 2), (4, 16, 2),
                  16, 8),
}


def numpy_filled(init, args, seed):
    """maua_tpu's init structure for `init(key, *args)` with numpy-drawn values: each weight N(0, 0.25 / fan_in),
    each 1-D leaf 0.1 N(0, 1) (gains, named g / ln_g, 1 + that)."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if len(leaf.shape) == 1:
            return jnp.asarray((name in ("g", "ln_g")) + 0.1 * rs.randn(*leaf.shape).astype(np.float32))
        fan_in = int(np.prod(leaf.shape[:-1]))
        return jnp.asarray((0.5 * rs.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32))

    shapes = jax.eval_shape(lambda k: getattr(JE, init)(k, *args), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_experimental_family_matches_maua_tpu(family):
    gi, gf, di, df, g_args, d_args, res, z_dim = FAMILIES[family]
    jg, jd = numpy_filled(gi, g_args, len(family)), numpy_filled(di, d_args, len(family) + 1)
    tg, td = bridge.experimental_params_to_torch(jax.device_get(jg)), bridge.experimental_params_to_torch(
        jax.device_get(jd))
    back = bridge.experimental_params_to_jax(tg)
    for a, b in zip(jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    z = np.random.RandomState(0).randn(3, z_dim).astype(np.float32)
    want = np.asarray(jax.jit(getattr(JE, gf))(jg, jnp.asarray(z)))
    got = getattr(TE, gf)(tg, torch.from_numpy(z))
    assert got.shape == (3, 3, res, res)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-4
    img = np.tanh(np.random.RandomState(1).randn(3, res, res, 3)).astype(np.float32)
    want_d = np.asarray(jax.jit(getattr(JE, df))(jd, jnp.asarray(img)))
    got_d = getattr(TE, df)(td, torch.from_numpy(img).permute(0, 3, 1, 2))
    assert got_d.shape == want_d.shape
    assert rel_err(got_d.numpy(), want_d) < 1e-4
    # the port's own init draws the same shapes
    gen = torch.Generator().manual_seed(0)
    own = getattr(TE, gi)(gen, *g_args)
    assert [tuple(t.shape) for t in TT.tree_leaves(own)] == [tuple(t.shape) for t in TT.tree_leaves(tg)]


def test_steerable_is_equivariant():
    gen = torch.Generator().manual_seed(1)
    g, d = TE.init_steerable_g(gen, 8, 4, 16, 2), TE.init_steerable_d(gen, 4, 16, 2)
    z = torch.randn(2, 8, generator=gen)
    out = TE.steerable_g(g, z)
    torch.testing.assert_close(TE.steerable_g(g, z, rotation=1), torch.rot90(out, 1, dims=(2, 3)), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(TE.steerable_d(d, out.flip(3)), TE.steerable_d(d, out), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- fit and checkpoints
@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rs.randint(0, 256, (20, 20, 3), dtype=np.uint8)).save(root / f"{i}.png")
    return root


def assert_states_equal(a, b, what="state"):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), what
        for k in b:
            assert_states_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_equal(x, y, f"{what}[{i}]")
    elif isinstance(b, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


def test_checkpoint_round_trip_and_resume_equal_an_uninterrupted_run(tmp_path):
    """Save after one step, load, take the second step from the file: the same state, bit for bit, as two
    steps in a row (the second with path length off, the first with R1 and path length)."""
    tg, td, tt = TG.SG2Config(**G_KW), TD.D2Config(**D_KW), TT.TrainConfig()
    state = TT.init_train_state(tg, td, tt, torch.Generator().manual_seed(0))
    reals = torch.tanh(torch.randn(2, 4, 3, 16, 16, generator=torch.Generator().manual_seed(1)))
    s1, _ = TT.train_step(state, reals[0], tg, td, tt, gen=torch.Generator().manual_seed(2))
    TL.save_checkpoint(str(tmp_path / "ck.pt"), s1)
    loaded = TL.load_checkpoint(str(tmp_path / "ck.pt"))
    assert_states_equal(loaded, s1)
    s2, m2 = TT.train_step(s1, reals[1], tg, td, tt, gen=torch.Generator().manual_seed(3))
    r2, n2 = TT.train_step(loaded, reals[1], tg, td, tt, gen=torch.Generator().manual_seed(3))
    assert_states_equal(r2, s2)
    assert {k: v.item() for k, v in m2.items()} == {k: v.item() for k, v in n2.items()}
    assert s2["step"] == 2 and s2["g_opt"][0]["count"] == 2


def test_fit_writes_the_grid_and_checkpoints(folder, tmp_path):
    from maua_tpu_torch.gan.data import ImageDataset, build_cache

    cache = build_cache(str(folder), 16, cache_dir=str(tmp_path))
    ds = ImageDataset(cache, 4, prefetch=1, device="cpu")
    out = tmp_path / "run"
    fit_cfg = TL.FitConfig(total_steps=3, eval_every=2, log_every=1, n_eval_images=16, out_dir=str(out),
                           ckpt_every=2, ckpt_top_k=1)
    state = TL.fit(ds, TG.SG2Config(**G_KW), TD.D2Config(**D_KW), TT.TrainConfig(blur_init_sigma=1.0), fit_cfg,
                   verbose=False)
    assert state["step"] == 3
    names = sorted(os.listdir(out))
    assert names == ["ckpt_0000002.pt", "ckpt_best.pt", "ckpt_final.pt", "grid_0000002.png", "grid_0000003.png"]
    assert Image.open(out / "grid_0000003.png").size == (64, 64)
    assert_states_equal(TL.load_checkpoint(str(out / "ckpt_final.pt")), to_device(state, "cpu"))


# ------------------------------------------------------------------- the CLI
def test_registry_names_equal_maua_tpus():
    from maua_tpu.gan import train_cli as JC

    assert {k: sorted(v) for k, v in TC.REGISTRY.items()} == {k: sorted(v) for k, v in JC.REGISTRY.items()}
    assert TC.EXPERIMENTAL_MODELS == JC.EXPERIMENTAL_MODELS and TC.REG_LOSSES == JC.REG_LOSSES


FLAG_SETS = [
    [],
    ["--loss", "cross_entropy", "-GL", "softplus", "path_length_regularization", "--lr_G", "1e-3",
     "--n_D_steps", "2", "-L", "uniform", "-A", "initial_blur", "ada", "--augment_p", "0.3", "--kimg", "1",
     "--ckpt_kimg", "1", "--test_kimg", "1", "--ema_decay", "0.99", "--blur_init_sigma", "2"],
    ["-e", "--model", "stylehypermixer", "--w_dim", "32", "--ndf", "8", "-DL", "softplus", "--total_steps", "5",
     "--eval_every", "5", "--batch_size", "4", "-A", "blur"],
    ["--model", "deepconvolutional", "--ngf", "8", "--resolution", "32", "--hflip", "--preprocess_image_size", "40",
     "--jpeg_quality", "80", "--monitor_metric", "kid", "--num_workers", "0"],
    ["-e", "-G", "steerable", "-D", "deepinvolutional", "--z_dim", "12", "--random_crop", "--random_rotate"],
]


def _captured(module, data_module, loop_module, monkeypatch, args):
    """The configurations `main` builds from args, with the data and fit stages replaced by recorders."""
    seen = {}
    monkeypatch.setattr(data_module, "build_cache", lambda input_dir, size, **kw: seen.update(cache=(size, kw)))
    monkeypatch.setattr(data_module, "ImageDataset",
                        lambda cache, batch, prefetch=0, data_augment=None, **kw: seen.update(
                            data=(batch, prefetch, data_augment is not None)))
    monkeypatch.setattr(loop_module, "fit", lambda ds, g, d, t, f: seen.update(cfgs=(g, d, t, f)))
    module.main(args)
    return seen


def _as_dicts(cfgs):
    return [c.__dict__ if hasattr(c, "__dict__") else c for c in cfgs]


@pytest.mark.parametrize("i", range(len(FLAG_SETS)))
def test_flag_surface_builds_what_maua_tpu_builds(i, monkeypatch, tmp_path):
    from maua_tpu.gan import data as JDATA
    from maua_tpu.gan import train_cli as JC
    from maua_tpu.gan import train_loop as JLOOP
    from maua_tpu_torch.gan import data as TDATA

    args = ["--input_dir", str(tmp_path)] + FLAG_SETS[i]
    want = _captured(JC, JDATA, JLOOP, monkeypatch, args)
    got = _captured(TC, TDATA, TL, monkeypatch, args)
    assert got["cache"] == want["cache"] and got["data"] == want["data"]
    assert _as_dicts(got["cfgs"]) == _as_dicts(want["cfgs"])


def test_experimental_models_need_the_flag(tmp_path):
    for flags in (["-G", "steerable"], ["--model", "deepinvolutional"], ["-D", "stylehypermixer"]):
        with pytest.raises(SystemExit, match="experimental"):
            TC.main(["--input_dir", str(tmp_path)] + flags)


def test_gan_train_command_runs_on_the_cpu(folder, tmp_path):
    """`python -m maua_tpu_torch gan train` at 16^2 for 2 steps (R1 and path length at step 0, the blur
    on), its one evaluation at the last step, the final state returned."""
    from maua_tpu_torch.__main__ import COMMANDS

    assert COMMANDS[("gan", "train")] == "maua_tpu_torch.gan.train_cli"
    out = tmp_path / "run"
    state = TC.main(["--input_dir", str(folder), "--cache_dir", str(tmp_path / "cache"), "--resolution", "16",
                     "--channel_base", "128", "--channel_max", "16", "--z_dim", "16", "--w_dim", "16",
                     "--batch_size", "4", "--total_steps", "2", "--out_dir", str(out), "--device", "cpu",
                     "--num_workers", "1"])
    assert state["step"] == 2 and state["pl_mean"].item() > 0
    assert {"ckpt_best.pt", "ckpt_final.pt", "grid_0000002.png"} <= set(os.listdir(out))


def test_run_as_a_script_the_cli_offers_every_model(capsys, monkeypatch):
    """maua_tpu's train_cli calls main() under `if __name__ == "__main__"` before the modules below it
    register the dcgan, hypermixer, involution and steerable models and the augmentations, so
    `python -m maua_tpu.gan.train_cli` offers only stylegan2 (a fault the port repairs: its guard is last).
    Witness: the --help of each run as a script."""
    import runpy
    import sys

    def help_text(module):
        monkeypatch.setattr(sys, "argv", [module, "--help"])
        with pytest.raises(SystemExit):
            runpy.run_module(module, run_name="__main__")
        return capsys.readouterr().out

    assert "deepconvolutional" not in help_text("maua_tpu.gan.train_cli")
    port = help_text("maua_tpu_torch.gan.train_cli")
    assert all(name in port for name in ("deepconvolutional", "stylehypermixer", "steerable", "--augment_p"))

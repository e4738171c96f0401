"""GAN training in the port (`maua_tpu_torch/gan/training.py`) against maua_tpu's, and the
epilogue's second-order gradient (`kernels/epilogue.ModconvEpilogue` under create_graph).

maua_tpu splits one key five ways a step and folds per-layer noise keys; the
tests make those draws with jax.random and hand them to the port's
train_step (`draws`). maua_tpu's train step returns Adam's new first moment,
which with beta1 = 0 is the step's gradient itself: the port's gradients
are held against it leaf by leaf. Parameters after a step are not the bar:
Adam's first step is about sign(g) lr, so a gradient at roundoff may move
a parameter by up to 2 lr on one side only.

Tolerances, of each tensor's largest magnitude: 1e-5 for the epilogue's
second-order gradients (the same ops summed in other orders); 1e-4 for the
losses, R1, path length, the logits, pl_mean and every gradient (f32, the
port's modulation scales the conv's output where maua_tpu's scales its
weights); the EMA within 1e-4 plus 2 lr (1 - beta), the reach of a sign
that roundoff flips in Adam's first step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import discriminator as JD
from maua_tpu.gan import stylegan2 as JG
from maua_tpu.gan import training as JT
from maua_tpu.kernels.epilogue import _xla_epilogue
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import discriminator as TD
from maua_tpu_torch.gan import stylegan2 as TG
from maua_tpu_torch.gan import training as TT
from maua_tpu_torch.kernels import epilogue as E
from test_torch_epilogue_grad import CASES, _draws
from test_torch_gan_discriminator import random_jax_d_params
from test_torch_stylegan2 import random_jax_params

torch.set_num_threads(1)

G_KW = dict(img_resolution=16, z_dim=16, w_dim=16, channel_base=128, channel_max=16, mapping_layers=2,
            num_fp16_res=0)
D_KW = dict(img_resolution=16, channel_base=128, channel_max=16)
BATCH = 4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_leaves_close(got, want, tol, what):
    """Leaf by leaf within tol of the leaf's largest magnitude; an all-zero leaf within tol of the tree's."""
    scale = max(float(np.abs(w).max()) for w in want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= tol * (np.abs(w).max() or scale), (what, i, err, np.abs(w).max())


# ------------------------------------------------------------- the repair
def _second_order(fn, z, post, nz, bias, pre_next, g, v, alpha, gain, clamp):
    """grad of s = sum_I <dL/dI, v_I> (the first-order gradients of <y, g>, taken with create_graph) with
    respect to every input and g: each is a second derivative of the epilogue."""
    ts = {k: None if a is None else torch.from_numpy(a).requires_grad_(True)
          for k, a in (("z", z), ("post", post), ("noise", nz), ("bias", bias), ("pre_next", pre_next), ("g", g))}
    names = [k for k in ("z", "post", "noise", "bias", "pre_next") if ts[k] is not None]
    y = fn(ts["z"], ts["post"], ts["noise"], ts["bias"], alpha, gain, clamp, ts["pre_next"])
    first = torch.autograd.grad(y, [ts[k] for k in names], ts["g"], create_graph=True)
    s = sum((d * torch.from_numpy(v[k])).sum() for k, d in zip(names, first))
    second = torch.autograd.grad(s, [ts[k] for k in names + ["g"]], allow_unused=True)
    return y, {k: np.zeros_like(ts[k].detach().numpy()) if d is None else d.numpy()
               for k, d in zip(names + ["g"], second)}


def _jax_second_order(z, post, nz, bias, pre_next, g, v, alpha, gain, clamp):
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    prim = {"z": nhwc(z), "post": jnp.asarray(post), "bias": jnp.asarray(bias), "g": nhwc(g)}
    if nz is not None:
        prim["noise"] = nhwc(nz)
    if pre_next is not None:
        prim["pre_next"] = jnp.asarray(pre_next)
    vv = {k: (nhwc(a) if a.ndim == 4 else jnp.asarray(a)) for k, a in v.items()}

    def s(p):
        def f(q):
            return _xla_epilogue(q["z"], q["post"], q.get("noise"), q["bias"], alpha, gain, clamp, q.get("pre_next"))

        q = {k: p[k] for k in p if k != "g"}
        _, vjp = jax.vjp(f, q)
        (d,) = vjp(p["g"])
        return sum(jnp.sum(d[k] * vv[k]) for k in d)

    out = jax.grad(s)(prim)
    return {k: np.asarray(a).transpose(0, 3, 1, 2) if a.ndim == 4 else np.asarray(a) for k, a in out.items()}


@pytest.mark.parametrize("noise,groups,pre,clamp", CASES)
def test_epilogue_second_order_gradient_matches_jax(noise, groups, pre, clamp):
    """A create_graph double backward through ModconvEpilogue over z, post, noise, bias, pre_next and g
    equals the plain version's and JAX's grad of the gradient of `_xla_epilogue`. Before the repair the
    Function's backward detached its inputs, and these second derivatives were lost."""
    z, post, nz, bias, pre_next, g = _draws(3, noise, groups, pre)
    rs = np.random.RandomState(9)
    v = {k: rs.randn(*a.shape).astype(np.float32) for k, a in
         (("z", z), ("post", post), ("noise", nz), ("bias", bias), ("pre_next", pre_next)) if a is not None}
    alpha, gain = 0.2, float(np.sqrt(2.0))
    y, got = _second_order(E.modconv_epilogue, z, post, nz, bias, pre_next, g, v, alpha, gain, clamp)
    assert type(y.grad_fn).__name__ == "ModconvEpilogueBackward"
    _, plain = _second_order(E.modconv_epilogue_plain, z, post, nz, bias, pre_next, g, v, alpha, gain, clamp)
    want = _jax_second_order(z, post, nz, bias, pre_next, g, v, alpha, gain, clamp)
    assert set(got) == set(want)
    for k in ("z", "post", "g"):  # z * post and g meet second-order terms in every case
        assert np.abs(want[k]).max() > 0, k
    for k in want:
        assert rel_err(got[k], want[k]) <= 1e-5 or np.abs(want[k]).max() == 0, k
        np.testing.assert_allclose(got[k], plain[k], rtol=1e-5, atol=1e-6 * max(np.abs(plain[k]).max(), 1e-30))


@pytest.fixture(scope="module")
def nets():
    jg, jd = JG.SG2Config(**G_KW), JD.D2Config(**D_KW)
    gp, dp = random_jax_params(jg, 5), random_jax_d_params(jd, 6)
    return jg, jd, gp, dp, TG.SG2Config(**G_KW), TD.D2Config(**D_KW)


def test_path_length_g_gradient_matches_jax_grad(nets):
    """The path-length penalty's gradient with respect to every G parameter (a double backward through
    the synthesis and its epilogues, and through ws back to the mapping) against jax.grad of maua_tpu's
    path_length_penalty; the penalty and the new pl_mean too."""
    jg, _, gp, _, tg, _ = nets
    z = np.random.RandomState(1).randn(BATCH, 16).astype(np.float32)
    key = jax.random.PRNGKey(3)
    pl_mean = 0.3

    def loss(p):
        ws = JG.mapping(p, jnp.asarray(z), jg)
        pen, new = JT.path_length_penalty(p, ws, key, jg, jnp.float32(pl_mean), decay=0.01, batch_shrink=2)
        return pen, new

    (want_pen, want_mean), want = jax.jit(jax.value_and_grad(loss, has_aux=True))(gp)
    noise = np.array(jax.random.normal(key, (BATCH // 2, 16, 16, 3))).transpose(0, 3, 1, 2).copy()
    tp, leaves = TT._with_grad(bridge.params_to_torch(gp))
    ws = TG.mapping(tp, torch.from_numpy(z), tg)
    pen, new = TT.path_length_penalty(tp, ws, tg, torch.tensor(pl_mean), decay=0.01, batch_shrink=2,
                                      noise=torch.from_numpy(noise))
    got = torch.autograd.grad(pen, leaves, allow_unused=True)
    got = [np.zeros(p.shape, np.float32) if g is None else g.numpy() for p, g in zip(leaves, got)]
    assert rel_err(pen.item(), float(want_pen)) < 1e-4 and rel_err(new.item(), float(want_mean)) < 1e-4
    assert_leaves_close(got, [t.numpy() for t in TT.tree_leaves(bridge.params_to_torch(want))], 1e-4, "dG")
    conv0 = tp["synthesis"]["b8"]["conv0"]["weight"]
    assert np.abs(got[next(i for i, t in enumerate(leaves) if t is conv0)]).max() > 0


# ------------------------------------------------------------------ losses
def test_losses_match_maua_tpu():
    rs = np.random.RandomState(2)
    real, fake = (rs.randn(7, 1).astype(np.float32) * 3 for _ in range(2))
    pairs = [(TT.g_logistic_loss(torch.from_numpy(fake)), JT.g_logistic_loss(jnp.asarray(fake))),
             (TT.g_bce_loss(torch.from_numpy(fake)), JT.g_bce_loss(jnp.asarray(fake))),
             (TT.d_logistic_loss(torch.from_numpy(real), torch.from_numpy(fake)),
              JT.d_logistic_loss(jnp.asarray(real), jnp.asarray(fake))),
             (TT.d_bce_loss(torch.from_numpy(real), torch.from_numpy(fake)),
              JT.d_bce_loss(jnp.asarray(real), jnp.asarray(fake)))]
    for got, want in pairs:
        assert rel_err(got.item(), float(want)) < 1e-6


def test_r1_penalty_and_its_gradient_match_maua_tpu(nets):
    _, jd, _, dp, _, td = nets
    x = np.tanh(np.random.RandomState(4).randn(3, 16, 16, 3)).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(lambda p: JT.r1_penalty(p, jnp.asarray(x), jd)))(dp)
    tree, leaves = TT._with_grad(bridge.d_params_to_torch(dp))
    got = TT.r1_penalty(tree, torch.from_numpy(x).permute(0, 3, 1, 2), td)
    got_g = torch.autograd.grad(got, leaves, allow_unused=True)  # b4.out's bias does not reach it
    assert rel_err(got.item(), float(want)) < 1e-4
    assert_leaves_close([np.zeros(p.shape) if g is None else g.numpy() for p, g in zip(leaves, got_g)],
                        [t.numpy() for t in TT.tree_leaves(bridge.d_params_to_torch(want_g))], 1e-4, "dR1")


@pytest.mark.parametrize("step", [0, 5, 12])
def test_initial_blur_matches_maua_tpu(step):
    """sigma 2 (a 7-tap kernel) fading over 40 images at batch 4: full at step 0, half at 5, gone at 12."""
    x = np.random.RandomState(step).randn(BATCH, 16, 16, 3).astype(np.float32)
    want = np.asarray(JT.initial_blur(jnp.asarray(x), jnp.int32(step), BATCH, 2.0, 0.32))
    got = TT.initial_blur(torch.from_numpy(x).permute(0, 3, 1, 2), step, BATCH, 2.0, 0.32)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5
    if step == 12:
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), x)


# -------------------------------------------------------------- train step
@functools.lru_cache(maxsize=None)
def _jax_draw_fn(g_cfg, batch, t_cfg):
    """One jitted function (key -> maua_tpu's train_step draws) per configuration."""
    n_d = max(t_cfg.n_d_steps, 1)
    n_pl = max(batch // t_cfg.pl_batch_shrink, 1)
    res = g_cfg.img_resolution

    @jax.jit
    def draw(key):
        kz_d, kz_g, kn_d, kn_g, kpl = jax.random.split(key, 5)

        def z(k):
            if t_cfg.latent == "uniform":
                return jax.random.uniform(k, (batch, g_cfg.z_dim), minval=-1.0, maxval=1.0) * jnp.sqrt(3.0)
            return jax.random.normal(k, (batch, g_cfg.z_dim))

        def noises(k):
            return {f"b{r}.conv{j}": jax.random.normal(jax.random.fold_in(k, 2 * bi + j), (batch, r, r, 1))
                    for bi, r in enumerate(g_cfg.block_resolutions) for j in ((1,) if r == 4 else (0, 1))}

        return {"z_d": [z(jax.random.fold_in(kz_d, i)) for i in range(n_d)],
                "noise_d": [noises(jax.random.fold_in(kn_d, i)) for i in range(n_d)],
                "z_g": z(kz_g), "noise_g": noises(kn_g), "pl_noise": jax.random.normal(kpl, (n_pl, res, res, 3))}

    return draw


def jax_draws(key, g_cfg, batch, t_cfg):
    """maua_tpu's train_step draws for `key`, in the port's layouts."""

    def torchify(a):
        a = np.array(a)
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a)

    return jax.tree_util.tree_map(torchify, jax.device_get(_jax_draw_fn(g_cfg, batch, t_cfg)(key)))


def jax_state(jg, jd, jt, seed):
    """maua_tpu's train state (init_train_state's structure) over numpy-filled parameters with nonzero
    biases, its Adam states from optax's own init."""
    g_opt, d_opt = JT.make_optimizers(jt)
    gp, dp = random_jax_params(jg, seed), random_jax_d_params(jd, seed + 1)
    return {"g_params": gp, "d_params": dp, "g_ema": jax.tree_util.tree_map(np.copy, gp), "g_opt": g_opt.init(gp),
            "d_opt": d_opt.init(dp), "pl_mean": jnp.zeros((), jnp.float32), "step": jnp.zeros((), jnp.int32)}


T_CFGS = {
    "logistic": JT.TrainConfig(n_d_steps=2, latent="uniform", blur_init_sigma=1.0, blur_fade_kimg=1.0),
    "bce": JT.TrainConfig(loss="bce", n_d_steps=2, latent="uniform", r1_interval=2, pl_interval=2),
}


@pytest.fixture(scope="module", params=sorted(T_CFGS))
def two_steps(request, nets):
    """Two maua_tpu steps (R1 and path length at step 0), and the port's steps from the same states and
    draws."""
    jg, jd, _, _, tg, td = nets
    jt = T_CFGS[request.param]
    tt = TT.TrainConfig(**jt.__dict__)
    state = jax_state(jg, jd, jt, 8)
    real = np.tanh(np.random.RandomState(7).randn(BATCH, 16, 16, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    # XLA's backend optimizations off: this step compiles in about half the time, its results within 2e-7
    step = jax.jit(lambda s, k: JT.train_step(s, jnp.asarray(real), k, jg, jd, jt)).lower(state, keys[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    rows = []
    for k in keys:
        new, metrics = step(state, k)
        port_state = bridge.train_state_to_torch(jax.device_get(state), bridge.params_to_torch,
                                                 bridge.d_params_to_torch)
        got = TT.train_step(port_state, torch.from_numpy(real).permute(0, 3, 1, 2), tg, td, tt,
                            draws=jax_draws(k, jg, BATCH, jt))
        rows.append((jax.device_get(new), jax.device_get(metrics), got))
        state = new
    return jt, rows


def test_train_step_gradients_match_maua_tpu(two_steps):
    """D's (the last of two D steps) and G's gradients leaf by leaf at step 0 (R1 and path length) and
    step 1: Adam's new first moment in the port's state against that in maua_tpu's (the gradient on both
    sides, beta1 being 0)."""
    jt, rows = two_steps
    assert jt.beta1 == 0.0
    for i, (new, _, (state, _)) in enumerate(rows):
        for net, conv in (("g", bridge.params_to_torch), ("d", bridge.d_params_to_torch)):
            want = [t.numpy() for t in TT.tree_leaves(conv(new[f"{net}_opt"][0].mu))]
            got = [g.numpy() for g in state[f"{net}_opt"][0]["mu"]]
            assert_leaves_close(got, want, 1e-4, f"d{net.upper()} at step {i}")


def test_train_step_metrics_state_and_ema_match_maua_tpu(two_steps):
    jt, rows = two_steps
    for i, (new, metrics, (state, got)) in enumerate(rows):
        assert state["step"] == int(new["step"]) == i + 1
        for k in ("d_loss", "g_loss", "real_logits", "fake_logits", "r1"):
            want = float(metrics[k])
            assert abs(got[k].item() - want) <= 1e-4 * max(abs(want), 1e-3), (i, k, got[k].item(), want)
        assert (float(metrics["r1"]) > 0) == (i % jt.r1_interval == 0)
        assert rel_err(state["pl_mean"].item(), float(new["pl_mean"])) < 1e-4
        if i == 0:
            assert float(new["pl_mean"]) > 0  # path length fired
        allow = 2 * jt.g_lr * (1 - jt.ema_beta)
        want = [t.numpy() for t in TT.tree_leaves(bridge.params_to_torch(new["g_ema"]))]
        for g, w in zip(TT.tree_leaves(state["g_ema"]), want):
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max() + allow
        assert state["g_opt"][0]["count"] == int(new["g_opt"][0].count)


def test_a_three_step_run_stays_finite():
    tg, td = TG.SG2Config(**G_KW), TD.D2Config(**D_KW)
    tt = TT.TrainConfig(r1_interval=2, pl_interval=2, blur_init_sigma=1.0)
    gen = torch.Generator().manual_seed(0)
    state = TT.init_train_state(tg, td, tt, gen)
    real = torch.tanh(torch.randn(3, 3, 16, 16, generator=gen))
    for i in range(3):
        state, metrics = TT.train_step(state, real, tg, td, tt, gen=gen)
        assert state["step"] == i + 1
        assert all(np.isfinite(v.item()) for v in metrics.values())
    leaves = TT.tree_leaves({k: state[k] for k in ("g_params", "d_params", "g_ema")})
    assert all(torch.isfinite(t).all() for t in leaves)
    assert state["g_opt"][0]["count"] == state["d_opt"][0]["count"] == 3


def test_train_step_without_gen_needs_every_draw():
    """Without a generator, a draw left out raises (a fixed seed would repeat it every step); with every
    draw given the step runs, and two runs agree."""
    tg, td, tt = TG.SG2Config(**G_KW), TD.D2Config(**D_KW), TT.TrainConfig()
    gen = torch.Generator().manual_seed(0)
    state = TT.init_train_state(tg, td, tt, gen)
    real = torch.tanh(torch.randn(4, 3, 16, 16, generator=gen))
    noises = lambda: {f"b{r}.conv{j}": torch.randn(4, 1, r, r, generator=gen)  # noqa: E731
                      for r in tg.block_resolutions for j in ((1,) if r == 4 else (0, 1))}
    draws = {"z_d": [torch.randn(4, tg.z_dim, generator=gen)], "noise_d": [noises()],
             "z_g": torch.randn(4, tg.z_dim, generator=gen), "noise_g": noises(),
             "pl_noise": torch.randn(2, 3, 16, 16, generator=gen)}
    for left_out in sorted(draws):
        with pytest.raises(ValueError, match=left_out):
            TT.train_step(state, real, tg, td, tt, draws={k: v for k, v in draws.items() if k != left_out})
    a, b = (TT.train_step(state, real, tg, td, tt, draws=draws)[0] for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(TT.tree_leaves(a["g_params"]), TT.tree_leaves(b["g_params"])))


def test_init_train_state_matches_maua_tpu_structure():
    jg, jd = JG.SG2Config(**G_KW), JD.D2Config(**D_KW)
    jstate = jax.eval_shape(lambda: JT.init_train_state(jax.random.PRNGKey(0), jg, jd, JT.TrainConfig()))
    state = TT.init_train_state(TG.SG2Config(**G_KW), TD.D2Config(**D_KW), TT.TrainConfig(),
                                torch.Generator().manual_seed(0))
    for net, conv in (("g", bridge.params_to_torch), ("d", bridge.d_params_to_torch)):
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jstate[f"{net}_params"])
        want = [tuple(t.shape) for t in TT.tree_leaves(conv(zeros))]
        assert [tuple(t.shape) for t in TT.tree_leaves(state[f"{net}_params"])] == want
        assert [tuple(t.shape) for t in state[f"{net}_opt"][0]["mu"]] == want
    assert state["step"] == 0 and state["pl_mean"].item() == 0.0

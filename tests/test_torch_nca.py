"""The port's texture NCA (`nca/nca.py`) against maua_tpu's on the CPU:
perception, a CA step, a rollout, three training steps and the evolution
video's frames, f32, with maua_tpu's draws (its keys' uniforms, pool
indices and rollout lengths) handed to the port and its key-0 VGG16
perceptor brought over by the bridge. Tolerances: perception and CA steps
within 1e-5 of their largest magnitude; the trained parameters and the
video frames at >= 40 dB PSNR (Adam's first steps divide each gradient by
its own magnitude, which magnifies roundoff where a gradient is near 0).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.nca import nca as J
from maua_tpu.perceptors import vgg as JVGG
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch import bridge
from maua_tpu_torch.nca import nca as T
from maua_tpu_torch.perceptors.vgg import VGGPerceptor

torch.set_num_threads(1)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


def _psnr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    peak = np.abs(b).max()
    return 10 * np.log10(peak**2 / max(np.mean((a - b) ** 2), 1e-30))


@pytest.fixture(scope="module")
def trained_params():
    """maua_tpu's init with a nonzero w2 (its zero init would make a step the identity)."""
    p = jax.tree_util.tree_map(np.asarray, J.init_params(jax.random.PRNGKey(1), 12, 96))
    p["w2"] = (np.random.RandomState(2).randn(1, 1, 96, 12) * 0.05).astype(np.float32)
    return p, bridge.nca_params_to_torch(p)


def test_perception_and_ca_step(trained_params):
    jp, tp = trained_params
    x = np.random.RandomState(3).randn(2, 9, 11, 12).astype(np.float32)
    _close(T.perception(torch.from_numpy(x)), J.perception(jnp.asarray(x)))
    key = jax.random.PRNGKey(4)
    want = J.ca_step(jp, jnp.asarray(x), key)
    u = np.array(jax.random.uniform(key, (2, 9, 11, 1)))
    _close(T.ca_step(tp, torch.from_numpy(x), u=torch.from_numpy(u)), want)
    xs, frames = J.rollout(jp, jnp.asarray(x), 3, key)
    masks = np.stack([np.asarray(jax.random.uniform(k, (2, 9, 11, 1))) for k in jax.random.split(key, 3)])
    txs, tframes = T.rollout(tp, torch.from_numpy(x), 3, masks=torch.from_numpy(masks))
    _close(txs, xs)
    _close(tframes, frames)
    drawn = T.init_params(torch.Generator().manual_seed(0))
    assert drawn["w1"].shape == (96, 48, 1, 1) and float(drawn["w2"].abs().max()) == 0.0


def test_train_nca_matches(monkeypatch):
    """Three steps at 16^2 (batch 2, pool 6, rollouts of 2 steps): maua_tpu's split keys replayed.
    maua_tpu's key-0 VGG16 is drawn once, under jit (the eager draw compiles layer by layer), for both."""
    kw = dict(n_steps=3, rollout_steps=(2, 3), batch=2, size=16, pool_size=6, verbose=False)
    style = (np.random.RandomState(5).rand(1, 16, 16, 3) * 2 - 1).astype(np.float32)
    key = jax.random.PRNGKey(6)
    vgg = jax.tree_util.tree_map(np.asarray, jax.jit(JVGG.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                                                        "vgg16"))
    draw = JVGG.init_params

    def drawn_once(k, arch="vgg19"):
        key0 = np.array_equal(np.asarray(k), np.asarray(jax.random.PRNGKey(0)))
        return jax.tree_util.tree_map(jnp.asarray, vgg) if key0 and arch == "vgg16" else draw(k, arch)

    monkeypatch.setattr(JVGG, "init_params", drawn_once)
    want = J.train_nca(jnp.asarray(style), key=key, **kw)
    percept = VGGPerceptor(arch="vgg16", params=bridge.guidance_params_to_torch(vgg), device="cpu")
    draws, k = [], key
    for _ in range(kw["n_steps"]):
        k, k1, k2, k3 = jax.random.split(k, 4)
        idx = np.asarray(jax.random.choice(k1, kw["pool_size"], (kw["batch"],), replace=False))
        n_roll = int(jax.random.randint(k2, (), *kw["rollout_steps"]))
        masks = np.stack([np.asarray(jax.random.uniform(kk, (kw["batch"], 16, 16, 1)))
                          for kk in jax.random.split(k3, n_roll)])
        draws.append((idx, n_roll, torch.from_numpy(masks)))
    params = bridge.nca_params_to_torch(jax.tree_util.tree_map(np.asarray, J.init_params(key, 12, 96)))
    stats = {}
    got = T.train_nca(torch.from_numpy(style), params=params, perceptor=percept, draws=lambda i: draws[i],
                      device="cpu", stats=stats, **kw)
    assert stats["rollouts"] == [d[1] for d in draws]
    assert len(stats["state_peaks"]) == len(stats["clipped"]) == 3 and all(0 <= c <= 1 for c in stats["clipped"])
    file_layout = T.params_to_file_layout(got)
    for name in ("w1", "b1", "w2"):
        assert _psnr(file_layout[name], np.asarray(want[name])) >= 40, name
    assert np.abs(np.asarray(want["w2"])).max() > 0  # training moved the zero-initialised update


def test_generate_video_frames_match(trained_params, monkeypatch, tmp_path):
    """31 frames at 16^2 (rollouts of 1 step, then one of 2), each package's writer replaced by a list."""
    import maua_tpu.ops.video as JV
    import maua_tpu_torch.ops.video as TV

    jp, tp = trained_params
    frames = {"j": [], "t": []}

    def fake(tag):
        class Writer:
            def __init__(self, *a, **k):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def write(self, f):
                frames[tag].append(np.asarray(f))
        return Writer

    monkeypatch.setattr(JV, "VideoWriter", fake("j"))
    monkeypatch.setattr(TV, "VideoWriter", fake("t"))
    key = jax.random.PRNGKey(7)
    J.generate_video(jp, str(tmp_path / "j.mp4"), size=16, num_frames=31, key=key)
    subs, k = [], key
    for _ in range(31):
        k, sub = jax.random.split(k)
        subs.append(sub)

    def masks(i, n):
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(kk, (1, 16, 16, 1)))
                                          for kk in jax.random.split(subs[i], n)]))

    T.generate_video(tp, str(tmp_path / "t.mp4"), size=16, num_frames=31, masks=masks, device="cpu")
    assert len(frames["t"]) == len(frames["j"]) == 31
    assert _psnr(np.stack(frames["t"]), np.stack(frames["j"])) >= 40


def test_nca_run_command(trained_params, monkeypatch, tmp_path):
    """`python -m maua_tpu_torch nca run --params p.pkl`: maua_tpu's pickle (HWIO) rendered on the CPU."""
    import maua_tpu_torch.ops.video as TV

    written = []

    class Writer:
        def __init__(self, path, *a, **k):
            written.append(path)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def write(self, f):
            assert f.shape == (8, 8, 3)

    monkeypatch.setattr(TV, "VideoWriter", Writer)
    jp, _ = trained_params
    with open(tmp_path / "tex.pkl", "wb") as f:
        pickle.dump(jp, f)
    cli_main.main(["nca", "run", "--params", str(tmp_path / "tex.pkl"), "--size", "8", "--num_frames", "3",
                   "--out_dir", str(tmp_path), "--device", "cpu"])
    assert written == [f"{tmp_path}/tex_nca.mp4"]

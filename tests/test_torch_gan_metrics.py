"""The port's GAN metrics (`maua_tpu_torch/gan/metrics.py`) and feature extractors
(`gan/extractors.py`) against maua_tpu's.

Features and images are numpy draws from seeds. Tolerances: FID and KID
1e-4 relative (f32 eigh and matmuls on both sides) on given features, and
through an extractor within 1e-4 of the sum of their terms (assert_distances_close),
PRDC 1e-6 (the same
counts of strict comparisons, their means rounded in other orders), Newton-Schulz 1e-5
of the root's largest entry, clean_resize 1e-5 of the image's range, the
extractors' features 1e-4 of their largest magnitude (f32 convs summed in
other orders; Inception at its smallest input, 75^2, SwAV at 32^2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.gan import extractors as JE
from maua_tpu.gan import metrics as JM
from maua_tpu_torch import bridge
from maua_tpu_torch.gan import extractors as TE
from maua_tpu_torch.gan import metrics as TM

torch.set_num_threads(1)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_distances_close(got, want, fr, ff):
    """FID and KID are differences of larger terms (traces, kernel means): f32 rounds those terms, so each
    is held within 1e-4 of the sum of its terms' magnitudes, computed from the features fr, ff."""
    fr, ff = np.asarray(fr, np.float64), np.asarray(ff, np.float64)
    fid_terms = np.trace(np.cov(fr.T)) + np.trace(np.cov(ff.T)) + np.square(fr.mean(0) - ff.mean(0)).sum()
    k = lambda a, b: (a @ b.T / fr.shape[1] + 1.0) ** 3  # noqa: E731
    kid_terms = np.abs(k(fr, fr)).mean() + np.abs(k(ff, ff)).mean() + 2 * np.abs(k(fr, ff)).mean()
    assert abs(got["fid"] - want["fid"]) <= 1e-4 * fid_terms, (got["fid"], want["fid"], fid_terms)
    assert abs(got["kid"] - want["kid"]) <= 1e-4 * kid_terms, (got["kid"], want["kid"], kid_terms)


@pytest.fixture(scope="module")
def feats():
    rs = np.random.RandomState(0)
    return rs.randn(24, 8).astype(np.float32), (rs.randn(20, 8) * 1.3 + 0.4).astype(np.float32)


def test_fid_and_kid_match_maua_tpu(feats):
    a, b = feats
    assert rel_err(TM.fid(torch.from_numpy(a), torch.from_numpy(b)).item(), float(JM.fid(jnp.asarray(a),
                                                                                          jnp.asarray(b)))) < 1e-4
    assert rel_err(TM.kernel_distance(torch.from_numpy(a), torch.from_numpy(b)).item(),
                   float(JM.kernel_distance(jnp.asarray(a), jnp.asarray(b)))) < 1e-4
    assert abs(TM.fid(torch.from_numpy(a), torch.from_numpy(a)).item()) < 1e-3


def test_prdc_matches_maua_tpu(feats):
    a, b = feats
    got = TM.prdc(torch.from_numpy(a), torch.from_numpy(b), nearest_k=3)
    want = JM.prdc(jnp.asarray(a), jnp.asarray(b), nearest_k=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert 0 < float(got["precision"]) < 1


def test_sqrtm_newton_schulz_matches_maua_tpu():
    m = np.random.RandomState(2).randn(6, 6).astype(np.float32)
    a = m @ m.T + 6 * np.eye(6, dtype=np.float32)
    got = TM.sqrtm_newton_schulz(torch.from_numpy(a)).numpy()
    want = np.asarray(JM.sqrtm_newton_schulz(jnp.asarray(a)))
    assert rel_err(got, want) < 1e-5
    assert rel_err(got @ got, a) < 1e-4


@pytest.mark.parametrize("size", [40, 7, 16])
def test_clean_resize_matches_maua_tpu(size):
    """Up, down (antialiased Keys cubic, a = -0.5) and the identity size."""
    x = np.random.RandomState(size).rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    want = np.asarray(JM.clean_resize(jnp.asarray(x), size))
    got = TM.clean_resize(torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() < 1e-5 * 2


@pytest.fixture(scope="module")
def resnets():
    """maua_tpu's ResNetExtractor with its normal draws taken from numpy: each new shape of an eager
    jax.random.normal compiles on its own (about 2.5 s a shape on the CPU)."""
    rs = np.random.RandomState(3)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JM.jax.random, "normal", lambda key, shape: jnp.asarray(rs.randn(*shape).astype(np.float32)))
        j = JM.ResNetExtractor(width=8, depth=(1, 1), feat_dim=16, key=jax.random.PRNGKey(3))
    t = TM.ResNetExtractor(params=bridge.resnet_extractor_params_to_torch(jax.device_get(j.params)))
    return j, t


def test_resnet_extractor_and_compute_metrics_match_maua_tpu(resnets):
    j, t = resnets
    rs = np.random.RandomState(5)
    real = np.tanh(rs.randn(12, 16, 16, 3)).astype(np.float32)
    fake = np.clip(real[::-1] + rs.randn(12, 16, 16, 3) * np.linspace(0.02, 0.6, 12)[:, None, None, None], -1,
                   1).astype(np.float32)
    want_f = np.asarray(j(jnp.asarray(real)))
    got_f = t(torch.from_numpy(real).permute(0, 3, 1, 2)).numpy()
    assert rel_err(got_f, want_f) < 1e-4
    want = JM.compute_metrics(real, fake, extractor=j, batch=5, nearest_k=3)
    got = TM.compute_metrics(real.transpose(0, 3, 1, 2), fake.transpose(0, 3, 1, 2), extractor=t, batch=5,
                             nearest_k=3, device="cpu")
    assert set(got) == set(want)
    assert_distances_close(got, want, got_f, t(torch.from_numpy(fake).permute(0, 3, 1, 2)).numpy())
    for k in ("precision", "recall", "density", "coverage"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["precision"] > 0 and got["coverage"] > 0


def test_compute_caches_real_features_like_maua_tpu(resnets, tmp_path, monkeypatch):
    """compute() over a folder (resampled to 24^2) against a generator's batches, with the folder's
    features cached under WORKSPACE/cache; the second call reads the cache."""
    from PIL import Image

    import maua_tpu.utility as JU
    import maua_tpu_torch.utility as TU

    j, t = resnets
    folder = tmp_path / "reals"
    folder.mkdir()
    rs = np.random.RandomState(6)
    for i in range(10):
        Image.fromarray(rs.randint(0, 256, (30, 30, 3), dtype=np.uint8)).save(folder / f"{i}.png")
    from maua_tpu.ops.image import resample

    imgs = np.concatenate([np.asarray(resample(jnp.asarray(np.asarray(Image.open(folder / f"{i}.png"), np.float32)[None]
                                                               / 255), 24)) for i in range(10)])
    imgs = np.clip(imgs[::-1] + rs.randn(*imgs.shape) * np.linspace(0.01, 0.3, 10)[:, None, None, None], 0,
                   1).astype(np.float32)
    fakes = [imgs[i : i + 4] for i in range(0, 12, 4)]
    monkeypatch.setattr(JU, "WORKSPACE", str(tmp_path / "jws"))
    monkeypatch.setattr(TU, "WORKSPACE", str(tmp_path / "tws"))

    def run(port):
        it = iter(fakes)
        if port:
            return TM.compute(str(folder), lambda: next(it).transpose(0, 3, 1, 2), n_samples=10, extractor=t,
                              batch_size=4, nearest_k=3, size=24, device="cpu")
        return JM.compute(str(folder), lambda: next(it), n_samples=10, extractor=j, batch_size=4, nearest_k=3,
                          size=24)

    want, got = run(False), run(True)
    cached = list((tmp_path / "tws" / "cache").iterdir())
    fr = np.load(cached[0])["features"]
    assert_distances_close(got, want, fr, t(torch.from_numpy(np.concatenate(fakes)[:10]).permute(0, 3, 1, 2) * 2 - 1))
    for k in ("precision", "recall", "density", "coverage"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["precision"] > 0 and got["coverage"] > 0
    assert [p.name for p in cached] == [p.name for p in (tmp_path / "jws" / "cache").iterdir()]
    np.testing.assert_allclose(np.load(cached[0])["features"],
                               np.load(next((tmp_path / "jws" / "cache").iterdir()))["features"], rtol=1e-4,
                               atol=1e-5)
    assert run(True) == got


@pytest.mark.parametrize("name,size", [("inception", 75), ("swav", 32)])
def test_extractor_forwards_match_maua_tpu(name, size):
    """Random state dicts in the published layouts (numpy seed 0, the same numbers on both sides),
    BN folded as maua_tpu folds it, at batch 2."""
    sd = getattr(JE, f"random_state_dict_{name}")(0)
    port_sd = getattr(TE, f"random_state_dict_{name}")(0)
    assert sd.keys() == port_sd.keys() and all(np.array_equal(sd[k], port_sd[k]) for k in sd)
    jp = getattr(JE, f"{name}_params_from_torch")(sd)
    tp = getattr(TE, f"{name}_params_from_torch")(sd)
    x = np.tanh(np.random.RandomState(1).randn(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(getattr(JE, f"{name}_forward"))(jp, jnp.asarray(x)))
    got = getattr(TE, f"{name}_forward")(tp, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert rel_err(got, want) < 1e-4


def test_get_extractor_builds_both_on_the_cpu(tmp_path):
    ext = TE.get_extractor("swav", device="cpu")
    assert ext.size == 224 and ext.feat_dim == 2048
    ckpt = tmp_path / "swav.pt"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in TE.random_state_dict_swav(1).items()}},
               ckpt)
    loaded = TE.load_swav(str(ckpt), device="cpu")
    want = TE.swav_params_from_torch(TE.random_state_dict_swav(1))
    assert all(torch.equal(loaded.params[k]["w"], want[k]["w"]) for k in want)
    with pytest.raises(ValueError):
        TE.get_extractor("vgg", device="cpu")

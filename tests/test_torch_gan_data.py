"""The port's training data pipeline (`maua_tpu_torch/gan/data.py`) against maua_tpu's.

The image folder is written from a numpy seed. The cache and the host-side
augmentations are numpy / PIL / OpenCV on both sides: equal byte for byte.
Batches are the same numbers in NCHW; augment_batch on explicit draws is
exact (a flip, a roll, an add and a clip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_tpu.gan import data as JD
from maua_tpu_torch.gan import data as TD

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    for i in range(10):
        h, w = (40, 56) if i % 2 else (48, 36)
        Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"im{i:02d}.png")
    (root / "sub").mkdir()
    Image.fromarray(rs.randint(0, 256, (30, 30, 3), dtype=np.uint8)).save(root / "sub" / "deep.jpg")
    return root


@pytest.mark.parametrize("jpeg_quality", [0, 75])
def test_build_cache_is_byte_equal(folder, tmp_path, jpeg_quality):
    a = TD.build_cache(str(folder), 24, cache_dir=str(tmp_path / "port"), jpeg_quality=jpeg_quality)
    b = JD.build_cache(str(folder), 24, cache_dir=str(tmp_path / "ref"), jpeg_quality=jpeg_quality)
    assert a.split("/")[-1] == b.split("/")[-1]
    assert open(a, "rb").read() == open(b, "rb").read()
    assert np.load(a).shape == (11, 24, 24, 3)
    assert TD.build_cache(str(folder), 24, cache_dir=str(tmp_path / "port"), jpeg_quality=jpeg_quality) == a


def test_make_data_augment_is_equal(folder, tmp_path):
    imgs = np.load(JD.build_cache(str(folder), 32, cache_dir=str(tmp_path)))
    kw = dict(hflip=True, vflip=True, random_crop=True, random_rotate=True, rotate_degrees=30.0)
    got = TD.make_data_augment(24, **kw)(imgs, np.random.default_rng(3))
    want = JD.make_data_augment(24, **kw)(imgs, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cache(folder, tmp_path_factory):
    return JD.build_cache(str(folder), 16, cache_dir=str(tmp_path_factory.mktemp("cache")))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_image_dataset_order_and_batches_match_maua_tpu(cache, prefetch):
    """Two epochs from the same seed (with a host augmentation drawing from the shared numpy Generator):
    the same images in the same order, NCHW f32 on the CPU; prefetch or not gives the same batches."""
    aug = TD.make_data_augment(16, hflip=True)
    got_ds = TD.ImageDataset(cache, 3, seed=5, prefetch=prefetch, data_augment=aug, device="cpu")
    want_ds = JD.ImageDataset(cache, 3, seed=5, prefetch=0, data_augment=JD.make_data_augment(16, hflip=True))
    assert len(got_ds) == len(want_ds) == 3
    for _ in range(2):
        got, want = list(got_ds), list(want_ds)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (3, 3, 16, 16)
            np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))


def test_prefetch_stops_when_the_consumer_stops(cache):
    ds = TD.ImageDataset(cache, 2, prefetch=1, device="cpu")
    it = iter(ds)
    next(it)
    it.close()  # the generator's finally sets stop and joins the thread
    import threading

    assert not any(t.name == "maua-data-prefetch" and t.is_alive() for t in threading.enumerate())


def test_augment_batch_matches_maua_tpu_on_its_draws():
    """maua_tpu's draws (its five split keys) handed to the port: flips, rolls and brightness agree exactly."""
    x = np.tanh(np.random.RandomState(1).randn(6, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(p_flip=0.5, p_translate=0.6, max_shift=0.25, p_color=0.5)
    want = np.asarray(JD.augment_batch(key, jnp.asarray(x), **kw))
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    m = int(kw["max_shift"] * 16)
    draws = {"flip": np.array(jax.random.bernoulli(k1, kw["p_flip"], (6,))),
             "do_t": np.array(jax.random.bernoulli(k2, kw["p_translate"], (6,))),
             "shift": np.array(jax.random.randint(k3, (6, 2), -m, m + 1)),
             "do_c": np.array(jax.random.bernoulli(k4, kw["p_color"], (6,))),
             "bright": np.array(jax.random.uniform(k5, (6,), minval=-0.2, maxval=0.2))}
    assert draws["flip"].any() and draws["do_t"].any() and draws["do_c"].any()
    got = TD.augment_batch(None, torch.from_numpy(x).permute(0, 3, 1, 2), draws=draws, **kw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    drawn = TD.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(x).permute(0, 3, 1, 2), **kw)
    assert drawn.shape == (6, 3, 16, 16) and float(drawn.abs().max()) <= 1.0

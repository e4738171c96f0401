"""The port's video ViT (`style/video_vit.py`) against maua_tpu's on the CPU:
the features and the gram-matched video style transfer, maua_tpu's
key-0 parameters brought over by the bridge, f32, a 4-frame 16^2 clip
through a narrow ViT (width 32, 2 layers, 2 heads, patch 4, tubelet 2).
Tolerances: features within 1e-5 of their largest magnitude; the stylised
clip after 4 Adam steps within 1e-4 (the content video holds exact +-1
pixels, where both clips halve the gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.style import video_vit as J
from maua_tpu_torch import bridge
from maua_tpu_torch.style import video_vit as T

torch.set_num_threads(1)

KW = dict(image_size=16, patch_size=4, tubelet=2, width=32, layers=2, heads=2)


@pytest.fixture(scope="module")
def vit():
    cfg = J.VideoViTConfig(**KW)
    params = jax.tree_util.tree_map(np.asarray, J.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, T.VideoViTConfig(**KW), params, bridge.video_vit_params_to_torch(params)


def _clip(seed, t=4):
    rs = np.random.RandomState(seed)
    v = np.clip(rs.randn(t, 16, 16, 3) * 0.7, -1, 1).astype(np.float32)
    return v  # some pixels sit exactly on +-1


def test_tubelets_and_features_match(vit):
    cfg, tcfg, params, tparams = vit
    v = _clip(1, t=5)  # an odd frame count: the last frame is dropped
    np.testing.assert_array_equal(T._tubelets(torch.from_numpy(v), tcfg).numpy(), np.asarray(J._tubelets(v, cfg)))
    want = J.features(params, jnp.asarray(v), cfg)
    got = T.features(tparams, torch.from_numpy(v), tcfg)
    assert len(got) == 2
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_video_style_transfer_matches(vit):
    cfg, tcfg, params, tparams = vit
    content, style = _clip(2), _clip(3)
    assert (np.abs(content) == 1).sum() > 10
    want = J.video_style_transfer(content, style, cfg, n_iters=4, lr=0.05, key=jax.random.PRNGKey(0), verbose=False)
    stats = {}
    got = T.video_style_transfer(content, style, tcfg, n_iters=4, lr=0.05, params=tparams, device="cpu",
                                 verbose=False, stats=stats)
    assert got.shape == content.shape and stats["loop_seconds"] > 0
    assert np.abs(want - content).max() > 1e-2  # the clip moved
    assert np.abs(got - want).max() <= 1e-4
    drawn = T.init_params(torch.Generator().manual_seed(0), tcfg)
    assert drawn["patch_proj"]["w"].shape == (32, 96) and drawn["pos_time"].shape == (64, 32)

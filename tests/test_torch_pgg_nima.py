"""The port's caffe perceptor zoo (`perceptors/pgg.py`) and NIMA
(`perceptors/nima.py`) against maua_tpu's.

Weights are seeded numpy draws in maua_tpu's layouts brought over by the
bridge, and one synthetic state dict in each published layout
(neural-style-pt's `features.N.*`; NIMA's `base_model.features.N.*` with a
(10, 25088) classifier) fed to both packages' `params_from_torch`. f32 on
the CPU. Tolerances: features within 1e-5 of each one's largest magnitude
(the same convs summed in other orders); NIMA's score and std within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.perceptors import nima as JN
from maua_tpu.perceptors import pgg as JP
from maua_tpu_torch import bridge
from maua_tpu_torch.perceptors import load_perceptor
from maua_tpu_torch.perceptors import nima as TN
from maua_tpu_torch.perceptors import pgg as TP

torch.set_num_threads(1)


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _conv_shapes(arch):
    """(co, ci, k) of each conv of a zoo entry."""
    if arch == "nin":
        out, ci = [], 3
        for co, k, *_ in JP.NIN_SPEC:
            out.append((co, ci, k))
            ci = co
        return out
    out, ci = [], 3
    for c in JP._channels(arch):
        if c != "P":
            out.append((c, ci, 3))
            ci = c
    return out


def _published_state_dict(arch, seed, prefix="features.", stride=2):
    """A neural-style-pt-like state dict: OIHW weights at spaced Sequential indices."""
    rs = np.random.RandomState(seed)
    sd = {}
    for i, (co, ci, k) in enumerate(_conv_shapes(arch)):
        scale = np.sqrt(2.0 / (ci * k * k)) / (255.0 if i == 0 else 1.0)
        sd[f"{prefix}{i * stride}.weight"] = (rs.randn(co, ci, k, k) * scale).astype(np.float32)
        sd[f"{prefix}{i * stride}.bias"] = (rs.randn(co) * 0.1).astype(np.float32)
    return sd


def _image(seed, h, w, lo=-1.0, hi=1.0):
    return (np.random.RandomState(seed).rand(1, h, w, 3) * (hi - lo) + lo).astype(np.float32)


@pytest.mark.parametrize("arch,pooling,size", [("vgg16", "max", (32, 32)), ("vgg19", "avg", (32, 40)),
                                               ("prune", "max", (32, 32)), ("nin", "max", (64, 72)),
                                               ("nin", "avg", (64, 72))])
def test_pgg_features_match(arch, pooling, size):
    sd = _published_state_dict(arch, 1)
    jparams = JP.params_from_torch(sd)
    tparams = TP.params_from_torch(sd)
    for got, want in zip(bridge.pgg_params_to_torch(jparams), tparams):  # the bridge gives the same tensors
        torch.testing.assert_close(got["w"], want["w"], rtol=0, atol=0)
    j = JP.PGGPerceptor(model_name=arch, params=jparams, pooling=pooling)
    t = TP.PGGPerceptor(model_name=arch, params=tparams, pooling=pooling, device="cpu")
    assert (t.content_layers, t.style_layers) == (list(j.content_layers), list(j.style_layers))
    img = _image(2, *size)
    jf, tf = j.get_features(jnp.asarray(img)), t.get_features(torch.from_numpy(img))
    assert len(tf) == len(jf) == len(_conv_shapes(arch))
    for i, (a, b) in enumerate(zip(tf, jf)):
        _close(a, b, 1e-5, f"{arch} feature {i}")


def test_pgg_checkpoint_file_and_names(tmp_path):
    sd = _published_state_dict("vgg16", 3)
    path = tmp_path / "vgg16.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    t = load_perceptor("pgg-vgg16")(checkpoint=str(path), device="cpu")
    j = JP.PGGPerceptor(model_name="vgg16", checkpoint=str(path))
    img = _image(4, 16, 16)
    _close(t.get_features(torch.from_numpy(img))[9], j.get_features(jnp.asarray(img))[9], 1e-5, "from the .pth")
    assert load_perceptor("nin").keywords == {"model_name": "nin"}
    assert load_perceptor("pgg").keywords == {"model_name": "vgg19"}
    drawn = load_perceptor("pruned")(device="cpu")
    assert drawn.model_name == "prune" and drawn.params[0]["w"].shape == (24, 3, 3, 3)
    assert TP.caffe_preprocess(torch.zeros(1, 1, 1, 3))[0, 0, 0].tolist() == pytest.approx(
        (127.5 - 103.939, 127.5 - 116.779, 127.5 - 123.68), abs=1e-4)


@pytest.fixture(scope="module")
def nima_sd():
    sd = {"base_model." + k: v for k, v in _published_state_dict("vgg16", 5).items()}
    rs = np.random.RandomState(6)
    sd["classifier.1.weight"] = (rs.randn(10, 25088) / np.sqrt(25088) * 4).astype(np.float32)
    sd["classifier.1.bias"] = (rs.randn(10) * 0.1).astype(np.float32)
    return sd


def test_nima_score_matches(nima_sd):
    jparams = JN.params_from_torch(nima_sd)
    tparams = TN.params_from_torch(nima_sd)
    converted = bridge.nima_params_to_torch(jparams)
    torch.testing.assert_close(converted["head"]["w"], tparams["head"]["w"], rtol=0, atol=0)
    torch.testing.assert_close(converted["vgg"][3]["w"], tparams["vgg"][3]["w"], rtol=0, atol=0)
    img = _image(7, 200, 232, 0.0, 1.0)  # shrinks: the antialiased bilinear resize, then the centre crop
    want = [np.asarray(a) for a in JN.nima_score(jnp.asarray(img), jparams)]
    got = [a.numpy() for a in TN.nima_score(torch.from_numpy(img), tparams)]
    _close(TN.distribution(tparams, torch.from_numpy(img)), JN.distribution(jparams, jnp.asarray(img)), 1e-5,
           "distribution")
    for g, w, what in zip(got, want, ("score", "std")):
        _close(g, w, 1e-5, what)


def test_nima_random_init_draws_maua_tpus_head():
    t = TN.init_params(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    want = (rng.standard_normal((25088, 10)) / np.sqrt(25088)).astype(np.float32)
    np.testing.assert_array_equal(t["head"]["w"].numpy(), want.T)
    with pytest.raises(KeyError, match="classifier"):
        TN.params_from_torch({"features.0.weight": np.zeros((64, 3, 3, 3), np.float32)})

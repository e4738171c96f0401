"""The port's openunmix-style source separation (audio/separate.py) and the
neural branch of `ar.separate_sources`, against maua_tpu.

At tests/test_separate.py's small config (n_fft 512, hidden 32, two LSTM
layers), f32 on the CPU, random networks from maua_tpu's own draws and
synthetic openunmix state dicts (that file's helper). Tolerances: masks
1e-4 relative and absolute (nn.LSTM against lax.scan, f32 summation
order), stems 1e-4 absolute on signals of peak ~0.8, the stems' sum
5e-3 from the mixture away from the edges (iSTFT edge effects).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.audio import separate as JS
from maua_tpu.audiovisual import audioreactive as JAR
from maua_tpu_torch.audio import separate as TS
from maua_tpu_torch.audiovisual import audioreactive as TAR
from test_separate import _torch_state_dict

CFG_KW = dict(n_fft=512, hop_length=128, hidden=32, lstm_layers=2, max_bin=100, niter=2)
CFG, TCFG = JS.UMXConfig(**CFG_KW), TS.UMXConfig(**CFG_KW)
SR = 16000


def song(seconds=1.0, seed=0, noise=0.05):
    t = np.arange(int(SR * seconds)) / SR
    rs = np.random.RandomState(seed)
    y = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 110 * t) + noise * rs.randn(t.size)
    return y.astype(np.float32)


def state_dicts(params):
    """maua_tpu's converted per-target parameters as the port's state dicts."""
    return {t: TS.state_dict_from_params(p) for t, p in params.items()}


def test_init_params_are_maua_tpus_numbers():
    want = state_dicts(JS.init_params(CFG, seed=3))
    got = TS.init_params(TCFG, seed=3)
    assert list(got) == list(JS.TARGETS) == list(TS.TARGETS)
    for t in TS.TARGETS:
        assert set(got[t]) == set(TS.OpenUnmix(TCFG).state_dict())
        for k, v in want[t].items():
            np.testing.assert_array_equal(got[t][k].numpy(), v.numpy(), err_msg=f"{t} {k}")


@pytest.mark.parametrize("stereo", [False, True])
def test_target_mask_of_an_openunmix_state_dict(stereo):
    """A synthetic openunmix state dict (nonzero biases, BN statistics and
    input/output scales), with a stereo fc1 folded as maua_tpu folds it."""
    sd = _torch_state_dict(CFG, seed=1)
    if stereo:
        sd["fc1.weight"] = torch.cat([sd["fc1.weight"], 0.5 * sd["fc1.weight"]], dim=1)
    jparams = JS.params_from_torch({"vocals": {k: v.numpy() for k, v in sd.items()}}, CFG)
    tparams = TS.params_from_torch({"vocals": sd}, TCFG)
    mag = np.abs(np.random.default_rng(2).standard_normal((20, CFG.n_bins))).astype(np.float32)
    want = np.asarray(JS.target_mask(jparams["vocals"], jnp.asarray(mag), CFG))
    got = TS.target_mask(tparams["vocals"], torch.from_numpy(mag), TCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got.min() >= 0 and got.max() > 0


def test_a_stereo_output_layer_is_refused():
    sd = _torch_state_dict(CFG, seed=1)
    sd["fc3.weight"] = torch.cat([sd["fc3.weight"]] * 2, dim=0)
    with pytest.raises(ValueError, match="fc3"):
        TS.params_from_torch({"vocals": sd}, TCFG)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_stems_match_maua_tpu_and_sum_to_the_mixture(noise):
    """The EM masks sum to 1 wherever some network's mask is nonzero, so
    the stems of the two tones (tests/test_separate.py's signal and seed)
    sum back to the mixture; with broadband noise, bins where all four
    relu masks are 0 drop out of every stem, in both packages alike."""
    y = song(noise=noise)
    jparams = JS.init_params(CFG, seed=3)
    want = [np.asarray(s) for s in JS.separate(y, SR, params=jparams, cfg=CFG)]
    got = [s.numpy() for s in TS.separate(torch.from_numpy(y), SR, params=state_dicts(jparams), cfg=TCFG)]
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == y.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    if not noise:
        mid = slice(CFG.n_fft, len(y) - CFG.n_fft)
        np.testing.assert_allclose(np.sum(got, axis=0)[mid], y[mid], atol=5e-3)


def test_separate_sources_neural_branch(tmp_path, monkeypatch):
    """Weights as params, as a directory of {target}.pth state dicts and
    random (neural=True), each against maua_tpu's branch; the DSP split
    stays the default without weights."""
    monkeypatch.setattr(JS, "UMXConfig", lambda: CFG)  # both branches build UMXConfig(): the small one here
    monkeypatch.setattr(TS, "UMXConfig", lambda: TCFG)
    y = song(0.5, seed=1)
    sds = {t: _torch_state_dict(CFG, seed=10 + i) for i, t in enumerate(JS.TARGETS)}
    for t, sd in sds.items():
        torch.save(sd, tmp_path / f"{t}.pth")
    jparams = JS.init_params(CFG, seed=0)
    cases = [(dict(params=jparams), dict(params=state_dicts(jparams))),
             (dict(checkpoint=str(tmp_path)), dict(checkpoint=str(tmp_path))),
             (dict(neural=True), dict(neural=True))]
    for jkw, tkw in cases:
        want = JAR.separate_sources(y, SR, **jkw)
        got = TAR.separate_sources(torch.from_numpy(y), SR, **tkw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=str(tkw)[:40])
    dsp = TAR.separate_sources(torch.from_numpy(y), SR)
    assert not np.allclose(dsp[0].numpy(), got[0].numpy(), atol=1e-3)

"""The port's neural flow estimators (spynet, pwc, liteflownet, unflow, raft,
gma) against maua_tpu's, on the CPU.

One synthetic checkpoint per estimator in its published key layout
(chip_smoke.flow_checkpoint: sniklaus spynet / pwc / liteflownet,
pytorch-unflow CSS, torchvision raft_large with folded batch norms, zacjiang
GMA with its `module.` prefix) goes through both packages' converters:
the port's `params_from_torch` must give what the bridge makes of
maua_tpu's, tensor for tensor. Both flows are then computed at full width
(RAFTConfig(): 12 iterations) on a 64^2 textured pair shifted 2 px, once
from that checkpoint and once from maua_tpu's own `init_params`
(PRNGKey(0)) carried over by the bridge; then `get_flow_model` over all six
from a MODELZOO holding the checkpoints, in both packages. maua_tpu's
flows are computed once per module.

Tolerances, f32: converted tensors equal; every flow within 1e-4 of the
largest flow magnitude (the max abs error is printed).

maua_tpu's estimators run their forwards op by op, and each new op compiles
on its first call (~75 s of the CPU's time for the six); the module jits
each forward instead, one compile each (~25 s), leaving the wrappers
(resizes, BGR, padding, scaling) as they are.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from maua_tpu import utility as jax_utility
from maua_tpu.flow import liteflownet as JLFN
from maua_tpu.flow import models as JM
from maua_tpu.flow import pwc as JPWC
from maua_tpu.flow import raft as JRAFT
from maua_tpu.flow import spynet as JSPY
from maua_tpu.flow import unflow as JUNF
from maua_tpu_torch import bridge, utility
from maua_tpu_torch.flow import liteflownet as TLFN
from maua_tpu_torch.flow import models as TM
from maua_tpu_torch.flow import pwc as TPWC
from maua_tpu_torch.flow import raft as TRAFT
from maua_tpu_torch.flow import spynet as TSPY
from maua_tpu_torch.flow import unflow as TUNF
from test_flow import _shifted_pair

NETS = chip_smoke.FLOW_NETS
# name -> (maua_tpu module, its flow function, its converter, the port's module, flow function, converter)
_MODULES = {
    "spynet": (JSPY, "spynet_flow", "params_from_torch", TSPY, "spynet_flow", "params_from_torch"),
    "pwc": (JPWC, "pwc_flow", "params_from_torch", TPWC, "pwc_flow", "params_from_torch"),
    "liteflownet": (JLFN, "liteflownet_flow", "params_from_torch", TLFN, "liteflownet_flow", "params_from_torch"),
    "unflow": (JUNF, "unflow_flow", "params_from_torch", TUNF, "unflow_flow", "params_from_torch"),
    "raft": (JRAFT, "raft_flow", "params_from_torch", TRAFT, "raft_flow", "params_from_torch"),
    "gma": (JRAFT, "raft_flow", "params_from_torch_gma", TRAFT, "raft_flow", "params_from_torch_gma"),
}
TOL = 1e-4


def _jax_init(name):
    key = jax.random.PRNGKey(0)
    if name == "pwc":  # eagerly, its ~60 parameter shapes compile one by one (~45 s); jitted, one program (~18 s)
        params = jax.jit(JPWC.init_params)(key)
        return {**params, "refiner_dil": tuple(int(d) for d in params["refiner_dil"])}
    return JRAFT.init_params(key, gma=True) if name == "gma" else _MODULES[name][0].init_params(key)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix: tree}


def _assert_flow_close(got, want, what):
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"{what}: max abs err {err:.3g} px of {scale:.3g}")
    assert got.shape == want.shape and scale > 0 and err <= TOL * scale, (what, err, scale)


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_forwards():
    with pytest.MonkeyPatch.context() as mp:
        for mod, fn in ((JSPY, "spynet_forward"), (JLFN, "liteflownet_forward"), (JUNF, "unflow_forward")):
            mp.setattr(mod, fn, jax.jit(getattr(mod, fn)))
        mp.setattr(JRAFT, "forward", jax.jit(JRAFT.forward, static_argnums=(3, 4)))
        # PWC's refiner dilations are Python ints in its tree: static arguments
        pwc_forward = JPWC.pwc_forward
        pwc = jax.jit(lambda p, a, b, dil: pwc_forward({**p, "refiner_dil": dil}, a, b), static_argnums=3)
        mp.setattr(JPWC, "pwc_forward", lambda p, a, b: pwc({k: v for k, v in p.items() if k != "refiner_dil"}, a, b,
                                                            tuple(p["refiner_dil"])))
        yield


@pytest.fixture(scope="module")
def pair():
    return _shifted_pair(shift=2, size=64)


@pytest.fixture(scope="module")
def checkpoints():
    return {name: chip_smoke.flow_checkpoint(name) for name in NETS}


@pytest.fixture(scope="module")
def jax_flows(pair, checkpoints):
    """maua_tpu's flow of the pair from each checkpoint and from each init_params."""
    out = {}
    for name in NETS:
        jmod, jfn, jconv = _MODULES[name][:3]
        ck = getattr(jmod, jconv)(checkpoints[name])
        out[name] = {"checkpoint": np.asarray(getattr(jmod, jfn)(*pair, params=ck)),
                     "init": np.asarray(getattr(jmod, jfn)(*pair, params=_jax_init(name)))}
    return out


@pytest.mark.parametrize("name", NETS)
def test_converters_give_the_same_tensors(name, checkpoints):
    jmod, _, jconv, tmod, _, tconv = _MODULES[name]
    sd = checkpoints[name]
    got = _flat(getattr(tmod, tconv)({k: torch.from_numpy(v) for k, v in sd.items()}))
    want = _flat(bridge.flow_params_to_torch(name, getattr(jmod, jconv)(sd)))
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert got[k].shape == want[k].shape, k
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name", NETS)
def test_flow_matches_maua_tpu(name, pair, checkpoints, jax_flows):
    _, _, _, tmod, tfn, tconv = _MODULES[name]
    params = getattr(tmod, tconv)(checkpoints[name])
    got = getattr(tmod, tfn)(*pair, params=params, device="cpu")
    _assert_flow_close(got, jax_flows[name]["checkpoint"], f"{name} from the checkpoint")
    bridged = bridge.flow_params_to_torch(name, _jax_init(name), "cpu")
    got = getattr(tmod, tfn)(*pair, params=bridged, device="cpu")
    _assert_flow_close(got, jax_flows[name]["init"], f"{name} from maua_tpu's init_params")


def test_get_flow_model_averages_the_checkpoints(pair, checkpoints, jax_flows, tmp_path, monkeypatch):
    for name in NETS:
        torch.save({k: torch.from_numpy(v) for k, v in checkpoints[name].items()},
                   tmp_path / chip_smoke.FLOW_CHECKPOINTS[name])
    monkeypatch.setattr(utility, "MODELZOO", str(tmp_path))
    monkeypatch.setattr(jax_utility, "MODELZOO", str(tmp_path))
    got = TM.get_flow_model(NETS, device="cpu")(*pair)
    # maua_tpu's get_flow_model over the same files; its members are the flows above
    want = JM.get_flow_model(NETS)(*pair)
    _assert_flow_close(want, np.mean([jax_flows[n]["checkpoint"] for n in NETS], axis=0), "maua_tpu's ensemble")
    _assert_flow_close(got, want, "the ensemble")


def test_get_flow_model_checkpoint_rules(pair, checkpoints, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(utility, "MODELZOO", str(tmp_path))
    for name in ("spynet", "pwc", "pwcnet", "liteflownet", "unflow", "raft", "raft_large", "gma"):
        with pytest.raises(FileNotFoundError, match="allow_random") as e:
            TM.get_flow_model((name,), device="cpu")
        assert str(tmp_path) in str(e.value)
    # allow_random: seed-0 random weights, as the estimator draws them with no parameters
    random = TM.get_flow_model(("spynet",), allow_random=True, device="cpu")(*pair)
    np.testing.assert_array_equal(random, TSPY.spynet_flow(*pair, device="cpu"))
    # a training-state file {"model": state_dict} loads; an unreadable one is reported, then random
    sd = {k: torch.from_numpy(v) for k, v in checkpoints["spynet"].items()}
    torch.save({"model": sd}, tmp_path / "spynet.pth")
    got = TM.get_flow_model(("spynet",), device="cpu")(*pair)
    np.testing.assert_array_equal(got, TSPY.spynet_flow(*pair, params=TSPY.params_from_torch(sd), device="cpu"))
    (tmp_path / "spynet.pth").write_bytes(b"not a checkpoint")
    with pytest.raises(FileNotFoundError, match="load errors"):
        TM.get_flow_model(("spynet",), device="cpu")
    TM.get_flow_model(("spynet",), allow_random=True, device="cpu")
    assert "using random init" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown flow model 'flownet2'"):
        TM.get_flow_model(("flownet2",), device="cpu")


def test_raft_lookup_and_upsampling_orders():
    """The lookup's (x, y) order and the convex upsampling's (8, 8) order, on inputs whose answer is known:
    a correlation map equal to its column index, sampled at integer coordinates, gives dx + x; a mask
    that puts all weight on the centre neighbour upsamples a constant flow to 8x that constant."""
    h = w = 6
    corr = torch.arange(w, dtype=torch.float32).expand(h * w, 1, h, w).contiguous()
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32), indexing="ij")
    coords = torch.stack([gx, gy], -1)[None]
    out = TRAFT._lookup([corr], coords, 1)  # (1, 9, H, W): dy outer, dx inner
    for dy in range(3):
        for dx in range(3):
            want = (gx + dx - 1).clamp(min=-1)
            want = torch.where((want >= 0) & (want < w) & (gy + dy - 1 >= 0) & (gy + dy - 1 < h), want, 0 * want)
            torch.testing.assert_close(out[0, dy * 3 + dx], want)
    flow = torch.stack([torch.full((h, w), 1.5), torch.full((h, w), -0.5)])[None]
    mask = torch.full((1, 9, 64, h, w), -30.0)
    mask[:, 4] = 30.0
    up = TRAFT._upsample_flow(flow, mask.reshape(1, 576, h, w))
    torch.testing.assert_close(up, flow.repeat_interleave(8, 2).repeat_interleave(8, 3) * 8)

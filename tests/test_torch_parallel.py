"""The port's parallel layer (mesh, pipeline, mixture of experts) and its callers against maua_tpu's, on the CPU.

maua_tpu runs its sharded paths on 8 virtual CPU devices (tests/conftest.py);
the port's mesh lists the one CPU device once per shard, and the shards run
in turn. Parameters come from maua_tpu's init through the bridge; the
sharded results (forward and gradient) are computed once per module.

Tolerances, f32: pipeline logits and gradients within 1e-4 absolute of
maua_tpu's sharded ones (its own bar against its unsharded forward) and
within 1e-5 of the port's unsharded forward; MoE outputs, aux losses and
gradients within 1e-5 absolute; tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from maua_tpu.autoregressive import transformer as JT
from maua_tpu.parallel import mesh as JMS
from maua_tpu.parallel import moe as JMOE
from maua_tpu.parallel import pipeline as JP
from maua_tpu_torch import bridge
from maua_tpu_torch.autoregressive import transformer as TT
from maua_tpu_torch.autoregressive import video as TVID
from maua_tpu_torch.parallel import mesh as TM
from maua_tpu_torch.parallel import moe as TMOE
from maua_tpu_torch.parallel import pipeline as TP

torch.set_num_threads(1)

CFG = JT.ARConfig(width=32, layers=4, heads=4, image_rows=4, image_cols=4, text_length=8, vocab_size=64,
                  text_vocab_size=64)
MOE_CFG = JMOE.MoEConfig(width=16, hidden=32, n_experts=8, top_k=2)
CPU = torch.device("cpu")


def port_cfg(cls, cfg):
    return cls(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def logical(n, axes=("stage",), shape=None):
    return TM.make_mesh(axes=axes, shape=shape, devices=[CPU] * n)


@pytest.fixture(scope="module")
def ar():
    params = JT.init_params(jax.random.PRNGKey(0), CFG)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, CFG.text_length + 16), 0, 64)
    mesh = JMesh(np.array(jax.devices()[:4]), ("stage",))

    def pp_fn(p):  # jitted: one compile, where op-by-op dispatch of the shard_map compiles every op
        return JP.pipeline_forward(p, tokens, CFG, mesh, num_microbatches=4)

    pp = np.asarray(jax.jit(pp_fn)(params))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(pp_fn(p) ** 2)))(params)
    return {"params": params, "tokens": np.array(tokens), "pp": pp, "grads": grads,
            "tparams": bridge.ar_params_to_torch(params), "tcfg": port_cfg(TT.ARConfig, CFG)}


def test_pipeline_forward_matches_maua_tpus_sharded_pipeline(ar):
    tokens = torch.from_numpy(ar["tokens"])
    out = TP.pipeline_forward(ar["tparams"], tokens, ar["tcfg"], logical(4), num_microbatches=4)
    np.testing.assert_allclose(out.numpy(), ar["pp"], atol=1e-4, rtol=0)
    ref = TT.forward(ar["tparams"], tokens, ar["tcfg"])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("stages,microbatches,remat", [(2, 2, False), (2, 8, False), (4, 4, True)])
def test_pipeline_schedule_is_free_of_its_shape(ar, stages, microbatches, remat):
    tokens = torch.from_numpy(ar["tokens"])
    ref = TT.forward(ar["tparams"], tokens, ar["tcfg"])
    out = TP.pipeline_forward(ar["tparams"], tokens, ar["tcfg"], logical(stages), num_microbatches=microbatches,
                              remat=remat)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_pipeline_gradient_matches_maua_tpus(ar):
    params = TM.tree_map(lambda x: x.clone().requires_grad_(True), ar["tparams"])
    out = TP.pipeline_forward(params, torch.from_numpy(ar["tokens"]), ar["tcfg"], logical(4), num_microbatches=4,
                              remat=True)
    names, leaves = zip(*_named_leaves(params))
    grads = torch.autograd.grad(torch.mean(out ** 2), leaves, allow_unused=True)  # frame_emb: no image frames
    want = dict(_named_leaves(bridge.ar_params_to_torch(jax.device_get(ar["grads"]))))
    assert set(want) == set(names)
    for name, got, leaf in zip(names, grads, leaves):
        got = torch.zeros_like(leaf) if got is None else got
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-4, rtol=0, err_msg=name)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _leaves(tree):
    return [x for _, x in _named_leaves(tree)]


def test_pipelined_apply_generic_mlp():
    gen = np.random.default_rng(2)
    layers = [{"w": torch.from_numpy(gen.standard_normal((16, 16)).astype(np.float32) * 0.2)} for _ in range(8)]
    x = torch.from_numpy(gen.standard_normal((4, 16)).astype(np.float32))
    ref = x
    for layer in layers:
        ref = torch.tanh(ref @ layer["w"])
    jlayers = [{"w": jnp.asarray(layer["w"].numpy())} for layer in layers]
    jmesh = JMesh(np.array(jax.devices()[:8]), ("pipe",))
    jout = jax.jit(lambda p, h: JP.pipelined_apply(jmesh, "pipe", p, lambda q, g: JP.scan_layers(
        lambda l, hh: jnp.tanh(hh @ l["w"]), q, g), h, 2))(JP.stack_stage_params(jlayers, 8), jnp.asarray(x.numpy()))
    out = TP.pipelined_apply(logical(8, ("pipe",)), "pipe", TP.stack_stage_params(layers, 8),
                             lambda p, h: TP.scan_layers(lambda l, hh: torch.tanh(hh @ l["w"]), p, h), x, 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        TP.stack_stage_params(layers[:6], 4)
    with pytest.raises(ValueError, match="microbatches"):
        TP.pipelined_apply(logical(2, ("pipe",)), "pipe", TP.stack_stage_params(layers, 2), lambda p, h: h, x, 3)


@pytest.fixture(scope="module")
def moe():
    params = JMOE.init_moe(jax.random.PRNGKey(3), MOE_CFG)
    x = jax.random.normal(jax.random.PRNGKey(4), (12, MOE_CFG.width))
    dense, aux = jax.jit(lambda p: JMOE.moe_apply(p, x, MOE_CFG))(params)
    emesh = JMesh(np.array(jax.devices()[:4]), ("expert",))
    dmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "expert"))
    ep, ep_aux = jax.jit(lambda p: JMOE.moe_apply_ep(p, x, MOE_CFG, emesh))(params)
    dp, dp_aux = jax.jit(lambda p: JMOE.moe_apply_ep(p, x, MOE_CFG, dmesh, data_axis="data"))(params)

    def loss(p):
        out, a = JMOE.moe_apply_ep(p, x, MOE_CFG, emesh)
        return jnp.mean(out ** 2) + 0.01 * a

    return {"params": params, "x": np.asarray(x), "dense": (np.asarray(dense), float(aux)),
            "ep": (np.asarray(ep), float(ep_aux)), "dp": (np.asarray(dp), float(dp_aux)),
            "grads": {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss))(params).items()},
            "tparams": bridge.moe_params_to_torch(params), "tcfg": port_cfg(TMOE.MoEConfig, MOE_CFG)}


def test_moe_dense_matches_maua_tpu(moe):
    out, aux = TMOE.moe_apply(moe["tparams"], t(moe["x"]), moe["tcfg"])
    np.testing.assert_allclose(out.numpy(), moe["dense"][0], atol=1e-5, rtol=0)
    assert abs(float(aux) - moe["dense"][1]) < 1e-5


@pytest.mark.parametrize("layout", ["expert", "data_expert"])
def test_moe_expert_parallel_matches_maua_tpus_sharded_path(moe, layout):
    if layout == "expert":
        out, aux = TMOE.moe_apply_ep(moe["tparams"], t(moe["x"]), moe["tcfg"], logical(4, ("expert",)))
        want = moe["ep"]
    else:
        mesh = logical(8, ("data", "expert"), (2, 4))
        out, aux = TMOE.moe_apply_ep(moe["tparams"], t(moe["x"]), moe["tcfg"], mesh, data_axis="data")
        want = moe["dp"]
    np.testing.assert_allclose(out.numpy(), want[0], atol=1e-5, rtol=0)
    assert abs(float(aux) - want[1]) < 1e-5
    dense, dense_aux = TMOE.moe_apply(moe["tparams"], t(moe["x"]), moe["tcfg"])
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    assert abs(float(aux) - float(dense_aux)) < 1e-6


def test_moe_gradient_matches_maua_tpus_sharded_gradient(moe):
    params = {k: v.clone().requires_grad_(True) for k, v in moe["tparams"].items()}
    out, aux = TMOE.moe_apply_ep(params, t(moe["x"]), moe["tcfg"], logical(4, ("expert",)))
    grads = torch.autograd.grad(torch.mean(out ** 2) + 0.01 * aux, list(params.values()))
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), moe["grads"][k], atol=1e-5, rtol=0, err_msg=k)


def test_moe_top1_routes_exclusively(moe):
    cfg1 = TMOE.MoEConfig(width=16, hidden=32, n_experts=8, top_k=1)
    gates, aux = TMOE.router_gates(moe["tparams"], t(moe["x"]), cfg1)
    jg, jaux = jax.jit(lambda p: JMOE.router_gates(p, jnp.asarray(moe["x"]), JMOE.MoEConfig(16, 32, 8, 1)))(moe["params"])
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    assert np.allclose((gates.numpy() > 0).sum(1), 1) and float(aux) >= 1.0 - 1e-6
    with pytest.raises(ValueError, match="divisible"):
        TMOE.moe_apply_ep(moe["tparams"], t(moe["x"]), moe["tcfg"], logical(3, ("expert",)))


def test_ep_shardings_split_expert_leaves():
    params = TMOE.init_moe(TMOE.MoEConfig(16, 32, 8, 2), torch.Generator().manual_seed(0))
    placed = TMOE.ep_shardings(params, logical(4, ("expert",)))
    assert placed["router"].shape == (16, 8)
    assert [c.shape for c in placed["w1"]] == [(2, 16, 32)] * 4
    torch.testing.assert_close(torch.cat(placed["b2"]), params["b2"], rtol=0, atol=0)


def test_mesh_layout_and_placement():
    mesh = TM.make_mesh(devices=[CPU])
    assert mesh.shape == {"data": 1, "tensor": 1} and mesh.distinct_devices == [CPU]
    jm = JMS.make_mesh(8, shape=(4, 2))
    tm = TM.make_mesh(8, shape=(4, 2), devices=[CPU] * 8)
    assert tm.shape == dict(jm.shape) and tm.axis_names == jm.axis_names
    tree = {"x": torch.zeros(4, 3), "y": [torch.ones(2)]}
    assert TM.shard_batch(tm, tree)["y"][0].device == CPU
    assert TM.shard_params(tm, tree)["x"].device == CPU
    spread = TM.Mesh(np.array([CPU, torch.device("meta")], dtype=object), ("data",))
    with pytest.raises(NotImplementedError, match="distinct devices"):
        TM.shard_batch(spread, tree)
    with pytest.raises(ValueError, match="no axis"):
        TM.shard_batch(tm, tree, axis="stage")


def test_multihost_stays_single_process(monkeypatch):
    for v in TM._CLUSTER_ENV:
        monkeypatch.delenv(v, raising=False)
    assert TM.initialize_multihost() is False
    assert TM.make_multihost_mesh().shape["data"] == len(TM.default_devices())


def test_tp_shardings_leaf_by_leaf(ar):
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "tensor"))
    want = JT.tp_shardings(ar["params"], jmesh)
    got = TT.tp_shardings(ar["tparams"], TM.make_mesh(8, shape=(4, 2), devices=[CPU] * 8))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    n = 0
    for path, sharding in flat:
        node = got
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert node == tuple(sharding.spec), (path, node, sharding.spec)
        n += 1
    assert n == len(_leaves(ar["tparams"]))
    with pytest.raises(ValueError, match="tensor"):
        TT.tp_shardings(ar["tparams"], logical(2))


def test_sharded_generation_equals_unsharded(ar):
    cfg = ar["tcfg"]
    text = torch.from_numpy(ar["tokens"][:2, : cfg.text_length])
    mesh = TM.make_mesh(2, shape=(1, 2), devices=[CPU] * 2)
    kw = dict(top_k=8)
    want = TT.generate_tokens(ar["tparams"], text, cfg, gen=torch.Generator().manual_seed(5), **kw)
    got = TVID.sharded_generate(ar["tparams"], text, cfg, mesh, gen=torch.Generator().manual_seed(5), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    vid_cfg = TT.ARConfig(**{**vars(cfg), "max_frames": 4})
    want = TVID.generate_video_tokens(ar["tparams"], text.numpy(), vid_cfg, 2, gen=torch.Generator().manual_seed(6))
    got = TVID.sharded_generate_video(ar["tparams"], text.numpy(), vid_cfg, mesh, n_frames=2,
                                      gen=torch.Generator().manual_seed(6))
    torch.testing.assert_close(got, want, rtol=0, atol=0)

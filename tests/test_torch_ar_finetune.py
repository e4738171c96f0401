"""The port's autoregressive finetuning against maua_tpu's, on the CPU.

quantized_adam (int8 blockwise moments), the one-cycle schedule with its
10-step floor, global-norm clipping and the frozen mask are held against
maua_tpu and optax step by step over 3 steps; `finetune_step` over 2 steps
(with and without int8 Adam, with gradient checkpointing), at the tiny
transformer of test_torch_autoregressive.py. maua_tpu's `.npz` checkpoints
restore into the port. The `autoregressive finetune` command runs end to end,
then samples from its checkpoint.

Tolerances, f32: updates and parameters 1e-5 of each leaf's largest
magnitude; the int8 codes equal; the loss 1e-5 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maua_tpu.autoregressive import finetune as JF
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch import bridge
from maua_tpu_torch import transforms as T
from maua_tpu_torch.autoregressive import finetune as TF
from maua_tpu_torch.gan.training import tree_leaves
from test_torch_autoregressive import TINY, ar, rel_close  # noqa: F401

torch.set_num_threads(1)


def leaves_close(got, want, tol=1e-5):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        rel_close(g, w, tol)


@pytest.mark.parametrize("schedule", [False, True])
def test_quantized_adam_matches(schedule):
    """Three steps on a (300,) and a (7, 5) leaf (300 spans two blocks of 256, the second padded)."""
    rs = np.random.RandomState(40)
    shapes = {"a": (300,), "b": (7, 5)}
    lr = optax.cosine_onecycle_schedule(10, 1e-2) if schedule else 1e-2
    tlr = T.cosine_onecycle_schedule(10, 1e-2) if schedule else 1e-2
    jtx, ttx = JF.quantized_adam(lr), TF.quantized_adam(tlr)
    params = {k: jnp.asarray(rs.randn(*s).astype(np.float32)) for k, s in shapes.items()}
    js, ts = jtx.init(params), ttx.init([torch.from_numpy(np.array(params[k])) for k in sorted(shapes)])
    for _ in range(3):
        g = {k: rs.randn(*s).astype(np.float32) * rs.uniform(0.01, 3) for k, s in shapes.items()}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        tu, ts = ttx.update([torch.from_numpy(g[k]) for k in sorted(shapes)], ts)
        for k, t in zip(sorted(shapes), tu):
            rel_close(t, ju[k])
        for k, t in zip(sorted(shapes), ts["state"]):
            for name in ("mq", "uq"):
                np.testing.assert_array_equal(t[name].numpy(), np.asarray(js["state"][k][name]))
            for name in ("ms", "us"):
                rel_close(t[name], js["state"][k][name])


def test_trainable_mask_matches(ar):
    params, tparams, _ = ar
    assert TF.trainable_mask(tparams) == jax.tree_util.tree_leaves(JF.trainable_mask(params))
    # trainable: 5 embedding tables, ln_f (2), the head, ln1 and ln2 (4 a block); frozen: qkv, proj, fc1
    # and fc2 (w and b) of both blocks
    assert TF.trainable_mask(tparams).count(True) == 16 and TF.trainable_mask(tparams).count(False) == 16


@pytest.mark.parametrize("train_text", [False, True])
def test_finetune_loss_matches(ar, train_text):
    params, tparams, cfg = ar
    tokens = np.concatenate([np.random.RandomState(41).randint(0, TINY.text_vocab_size, (3, TINY.text_length)),
                             np.random.RandomState(42).randint(0, TINY.vocab_size, (3, TINY.image_length))
                             + TINY.text_vocab_size], 1)
    want = float(JF.finetune_loss(params, jnp.asarray(tokens), TINY, 7.0, train_text))
    got = float(TF.finetune_loss(tparams, torch.from_numpy(tokens), cfg, 7.0, train_text))
    assert abs(got - want) <= 1e-5 * abs(want)


def _batches(n, seed=43):
    rs = np.random.RandomState(seed)
    return [np.concatenate([rs.randint(0, TINY.text_vocab_size, (2, TINY.text_length)),
                            rs.randint(0, TINY.vocab_size, (2, TINY.image_length)) + TINY.text_vocab_size], 1)
            for _ in range(n)]


def code_flips(js, ts, mask):
    """Per parameter leaf, the elements whose int8 codes (m or sqrt(v)) differ between the packages' states
    (frozen leaves: none); asserts that no code differs by more than one step and that few differ."""
    jcodes = {k: [np.asarray(leaf).reshape(-1) for p, leaf in jax.tree_util.tree_flatten_with_path(js["opt"])[0]
                  if jax.tree_util.keystr(p).endswith(f"['{k}']")] for k in ("mq", "uq")}
    flips, i = [], 0
    for m, p in zip(mask, tree_leaves(ts["params"])):
        f = np.zeros(p.numel(), bool)
        if m:
            for k in ("mq", "uq"):
                d = np.abs(ts["opt"][1]["train"]["state"][i][k].numpy().reshape(-1).astype(int)
                           - jcodes[k][i].astype(int))[: p.numel()]
                assert d.max() <= 1
                f |= d > 0
            i += 1
        flips.append(f.reshape(p.shape))
    assert sum(int(f.sum()) for f in flips) <= 8
    return flips


@pytest.mark.parametrize("adam8bit,remat", [(True, False), (False, False), (True, True)])
def test_finetune_step_matches(ar, adam8bit, remat):
    """Two steps at lr 1e-2 over 4 steps' schedule (the horizon floored at 10), train_text on; parameters
    within 1e-5 of each leaf's largest magnitude. int8 Adam divides by sqrt(v) plus a floor of half a code
    step, so where a gradient entry is near that floor (1e-4 of the leaf's largest here) the update
    follows its relative error: the entries' f32 summation-order differences (1e-6 of the largest, 2e-3
    of such an entry) reach 1e-3 of lr, which is that path's added bar. A moment rounded to the
    neighbouring int8 code (at most 8 codes, by one step each) moves the next step by up to lr / 127 at
    that element, which those elements are held to."""
    params, tparams, cfg = ar
    jft = JF.FinetuneConfig(lr=1e-2, steps=4, adam8bit=adam8bit, gradient_checkpointing=remat, train_text=True)
    tft = TF.FinetuneConfig(lr=1e-2, steps=4, adam8bit=adam8bit, gradient_checkpointing=remat, train_text=True)
    js = JF.init_finetune_state(params, jft)
    ts = TF.init_finetune_state(tparams, tft)
    mask = TF.trainable_mask(tparams)
    flips = [np.zeros(tuple(p.shape), bool) for p in tree_leaves(tparams)]
    for tokens in _batches(2):
        js, jl = JF.finetune_step(js, jnp.asarray(tokens), TINY, jft)
        ts, tl = TF.finetune_step(ts, torch.from_numpy(tokens), cfg, tft)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        for f, g, w in zip(flips, tree_leaves(ts["params"]), jax.tree_util.tree_leaves(js["params"])):
            g, w = g.numpy(), np.asarray(w)
            assert np.abs(g - w)[~f].max(initial=0) <= 1e-5 * np.abs(w).max() + (1e-3 * 1e-2 if adam8bit else 0)
            assert np.abs(g - w)[f].max(initial=0) <= 2 * 1e-2 / 127
        if adam8bit:
            flips = [a | b for a, b in zip(flips, code_flips(js, ts, mask))]
    assert ts["step"] == int(js["step"]) == 2
    # the frozen leaves did not move
    for m, p0, p in zip(TF.trainable_mask(tparams), tree_leaves(tparams), tree_leaves(ts["params"])):
        assert m or torch.equal(p0, p)


def test_maua_tpu_checkpoints_restore_into_the_port(ar, tmp_path):
    params, tparams, cfg = ar
    moved = jax.tree_util.tree_map(lambda x: x + 1.0, params)
    JF.save_checkpoint(str(tmp_path / "j.npz"), {"params": moved})
    got = TF.restore_checkpoint(str(tmp_path / "j.npz"), {"params": tparams})["params"]
    leaves_close(got, moved, tol=0.0)
    # and the port's file restores into maua_tpu
    TF.save_checkpoint(str(tmp_path / "t.npz"), {"params": got})
    back = JF.restore_checkpoint(str(tmp_path / "t.npz"), {"params": params})["params"]
    leaves_close(got, back, tol=0.0)


def test_finetune_loop_and_interrupt_save(ar, tmp_path):
    _, tparams, cfg = ar
    ft = TF.FinetuneConfig(lr=1e-3, steps=3, adam8bit=True)
    new, losses = TF.finetune(tparams, iter(_batches(5)), cfg, ft, save_path=str(tmp_path / "run.npz"),
                              verbose=False)
    assert len(losses) == 3 and all(np.isfinite(losses))
    state = TF.restore_checkpoint(str(tmp_path / "run.npz"), TF.init_finetune_state(tparams, ft))
    assert state["step"] == 3 and state["opt"][1]["train"]["count"] == 3
    leaves_close(state["params"], bridge.ar_params_to_jax(new), tol=0.0)

    def interrupted():
        yield _batches(1)[0]
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        TF.finetune(tparams, interrupted(), cfg, ft, save_path=str(tmp_path / "cut.npz"), verbose=False)
    assert os.path.exists(tmp_path / "cut_keyboardinterrupt.npz")


@pytest.mark.parametrize("adam8bit", [False, True])
def test_finetune_command_then_generate(tmp_path, adam8bit):
    from PIL import Image

    rs = np.random.RandomState(44)
    paths = []
    for i in range(2):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rs.randint(0, 256, (40, 40, 3)).astype(np.uint8)).save(p)
        paths.append(str(p))
    ckpt = tmp_path / "ft.npz"
    cli_main.main(["autoregressive", "finetune", "--images", *paths, "--captions", "a cat", "a dog", "--steps", "3",
                   "--train_batch_size", "2", "--save_path", str(ckpt), "--num_outputs", "1",
                   "--output_dir", str(tmp_path / "samples"), "--device", "cpu"] + (["--adam8bit"] if adam8bit else []))
    assert ckpt.exists() and os.listdir(tmp_path / "samples") == ["im0_0.png"]
    cli_main.main(["autoregressive", "generate", "--text", "a cat", "--num_outputs", "1", "--checkpoint", str(ckpt),
                   "--output_dir", str(tmp_path / "gen"), "--device", "cpu"])
    assert os.listdir(tmp_path / "gen") == ["ar_0.png"]

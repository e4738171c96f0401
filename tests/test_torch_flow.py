"""The port's optical flow utilities and the flow-warped video pipelines
against maua_tpu's, on the CPU: the mflo codec, `.flo` files and the
colour coding, warp maps, the consistency check, Horn-Schunck flow, the
estimator registry, the cached preprocessing, VideoFlowDiffusionProcessor
and loop_direct_sample.

A tiny synthetic clip (4 frames of 24^2 texture panning a pixel a frame,
written by the port's writer) at 16^2 synthesis. The pipelines run with a
deterministic stub processor (as tests/test_loop_direct.py does) over
turbo, wrap_around, hist_persist, first_frame_init and a random init, and
once with Stable Diffusion at the tiny sizes of tests/test_torch_diffusion.py.
JAX's draws (noise injection, the random init, each pass's roll, the
processor's latent noise, histogram matching's jitter) are handed to the
port.

Tolerances, f32: the codecs and the colour coding exactly; warp maps,
the consistency mask and the stub pipelines' frames 1e-5 (absolute, on
[-1, 1] images and [0, 1] masks); Horn-Schunck 1e-4 pixel; the SD pass's
frames PSNR >= 40 dB (peak 2; the max abs error is printed).
"""

import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.diffusion.loop_direct as JLD
import maua_tpu.diffusion.video as JVID
import maua_tpu.flow.lib as JLIB
from maua_tpu.diffusion.processors.base import BaseDiffusionProcessor as JaxBase
from maua_tpu.diffusion.processors.stable import StableDiffusion as JaxSD
from maua_tpu.flow import consistency as JC
from maua_tpu.flow import models as JM
from maua_tpu.flow import viz as JVIZ
from maua_tpu_torch import utility
from maua_tpu_torch.diffusion import loop_direct as TLD
from maua_tpu_torch.diffusion import video as TVID
from maua_tpu_torch.diffusion.processors.base import BaseDiffusionProcessor
from maua_tpu_torch.diffusion.processors.stable import StableDiffusion
from maua_tpu_torch.flow import consistency as TC
from maua_tpu_torch.flow import lib as TLIB
from maua_tpu_torch.flow import models as TM
from maua_tpu_torch.flow import viz as TVIZ
from maua_tpu_torch.ops.video import write_video
from test_flow import _shifted_pair
from test_torch_diffusion import _psnr
from test_torch_guided_diffusion import _sd_kwargs, make_sd_params
from test_torch_image_ops import jax_jitter


def _close(got, want, atol):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= atol, err


# ------------------------------------------------------------------ codecs and maps
def test_mflo_flo_and_colour_coding_match(tmp_path):
    rs = np.random.RandomState(70)
    flow = (rs.randn(30, 44, 2) * 5).astype(np.float32)
    np.testing.assert_array_equal(TLIB.encode_mflo(flow), JLIB.encode_mflo(flow))
    np.testing.assert_array_equal(TLIB.decode_mflo(TLIB.encode_mflo(flow)), JLIB.decode_mflo(JLIB.encode_mflo(flow)))
    assert np.abs(TLIB.decode_mflo(TLIB.encode_mflo(flow)) - flow).max() < np.abs(flow).max() / 100
    np.testing.assert_array_equal(TLIB.encode_mflo(np.zeros_like(flow)), JLIB.encode_mflo(np.zeros_like(flow)))
    TVIZ.write_flo(flow, str(tmp_path / "a.flo"))
    np.testing.assert_array_equal(JVIZ.read_flo(str(tmp_path / "a.flo")), flow)
    JVIZ.write_flo(flow, str(tmp_path / "b.flo"))
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    np.testing.assert_array_equal(TVIZ.read_flo(str(tmp_path / "b.flo")), flow)
    (tmp_path / "c.flo").write_bytes((tmp_path / "a.flo").read_bytes()[:-8])
    with pytest.raises(ValueError, match="truncated"):
        TVIZ.read_flo(str(tmp_path / "c.flo"))
    with pytest.raises(ValueError, match="magic"):
        TVIZ.read_flo(_bad_magic(tmp_path))
    odd = flow.copy()
    odd[3, 4] = np.nan
    odd[5, 6] = 1e9
    for f in (flow, odd, np.zeros_like(flow)):
        np.testing.assert_array_equal(TVIZ.flow_to_image(f), JVIZ.flow_to_image(f))


def _bad_magic(tmp_path):
    path = tmp_path / "bad.flo"
    path.write_bytes(np.float32(1.0).tobytes() + np.int32(1).tobytes() * 2 + np.zeros(2, np.float32).tobytes())
    return str(path)


def test_warp_map_consistency_and_horn_schunck_match():
    f1, f2 = _shifted_pair(shift=2, size=32)
    fwd, bwd = JM.farneback_flow(f1, f2), JM.farneback_flow(f2, f1)
    np.testing.assert_array_equal(TM.farneback_flow(f1, f2), fwd)
    _close(TLIB.flow_warp_map(fwd), JLIB.flow_warp_map(fwd), 1e-6)
    _close(TLIB.flow_warp_map(np.stack([fwd, bwd])), JLIB.flow_warp_map(np.stack([fwd, bwd])), 1e-6)
    for a, b in ((fwd, bwd), (fwd[None], bwd[None])):
        _close(TC.check_consistency(a, b), JC.check_consistency(a, b), 1e-5)
    assert TC.check_consistency(fwd, bwd)[8:-8, 8:-8].mean() > 0.6  # a translation: mostly reliable
    rs = np.random.RandomState(71)
    noisy = [(rs.randn(32, 32, 2) * 4).astype(np.float32) for _ in range(2)]
    want = np.asarray(JC.check_consistency(*noisy))
    _close(TC.check_consistency_np(*noisy), want, 1e-5)
    assert want.mean() < 0.5  # independent flows: mostly unreliable
    for mode in ("full", "magnitude", "none"):
        _close(TLIB.get_consistency_map(fwd, bwd, mode), JLIB.get_consistency_map(fwd, bwd, mode), 1e-5)
    want = np.asarray(JM.jax_flow(f1, f2))
    got = TM.hs_flow(f1, f2, device="cpu")
    _close(got, want, 1e-4)
    assert abs(np.median(want[8:-8, 8:-8, 0]) - 2.0) < 1.0  # it finds the shift
    _close(TM.get_flow_model(("hs",), device="cpu")(f1, f2), want, 1e-4)


def test_get_flow_model_names_and_errors(monkeypatch):
    f1, f2 = _shifted_pair(shift=2, size=32)
    farneback = TM.farneback_flow(f1, f2)
    both = TM.get_flow_model(("farneback", "jax"), device="cpu")(f1, f2)
    _close(both, (farneback + TM.hs_flow(f1, f2, device="cpu").numpy()) / 2, 1e-6)
    _close(both, JM.get_flow_model(("farneback", "jax"))(f1, f2), 1e-4)
    # the neural estimators need their checkpoints (tests/test_torch_flow_neural.py runs them)
    monkeypatch.setattr(utility, "MODELZOO", "/nonexistent")
    for name in ("spynet", "pwc", "pwcnet", "liteflownet", "unflow", "raft", "gma", "raft_large"):
        with pytest.raises(FileNotFoundError, match="allow_random"):
            TM.get_flow_model((name,), device="cpu")
    # maua_tpu prints a message and substitutes Farneback for an unknown name; the port refuses it
    with pytest.raises(ValueError, match="unknown flow model 'sparse'"):
        TM.get_flow_model(("farneback", "sparse"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.get_flow_model(("hs",))
    np.testing.assert_array_equal(TM.get_flow_model()(f1, f2), farneback)  # Farneback runs on the host


# ------------------------------------------------------------------ cached preprocessing
@pytest.fixture()
def clip(tmp_path):
    path = str(tmp_path / f"clip_{uuid.uuid4().hex[:8]}.mp4")
    rs = np.random.RandomState(72)
    base = np.repeat(np.repeat(rs.rand(6, 6, 3), 4, 0), 4, 1).astype(np.float32) * 0.8 + 0.1
    write_video(np.stack([np.roll(base, s, axis=1) for s in range(4)]), path, fps=8, value_range=(0, 1))
    return path


@pytest.fixture()
def workspaces(tmp_path, monkeypatch):
    """Separate WORKSPACE directories for maua_tpu and the port, so each computes its own caches."""
    jax_ws, port_ws = tmp_path / "jax", tmp_path / "port"
    for module in (JLIB, JVID, JLD):
        monkeypatch.setattr(module, "WORKSPACE", str(jax_ws))
    monkeypatch.setattr(utility, "WORKSPACE", str(port_ws))
    return jax_ws, port_ws


def test_preprocess_optical_flow_caches_by_frame_count(clip, workspaces):
    jax_ws, port_ws = workspaces
    calls = []

    def counted(a, b):
        calls.append(1)
        return TM.farneback_flow(a, b)

    want = JLIB.preprocess_optical_flow(clip, JM.farneback_flow, max_frames=3)
    got = TLIB.preprocess_optical_flow(clip, counted, max_frames=3)
    assert len(calls) == 6 and got[0].shape == (3, 24, 24, 3)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    stem = clip.split("/")[-1][:-4] + "_n3"
    assert sorted(p.name for p in port_ws.iterdir()) == sorted(p.name for p in jax_ws.iterdir()) == sorted(
        f"{stem}_{s}.npy" for s in ("content", "forward_flow", "backward_flow", "reliable_full_flow"))
    again = TLIB.preprocess_optical_flow(clip, counted, max_frames=3)  # from the cache
    assert len(calls) == 6 and all(isinstance(a, np.memmap) for a in again)
    TLIB.preprocess_optical_flow(clip, counted, consistency="magnitude", max_frames=3)  # a new mask, no new flow
    assert len(calls) == 6 and (port_ws / f"{stem}_reliable_magnitude_flow.npy").exists()
    TLIB.preprocess_optical_flow(clip, counted)  # all frames: another key
    assert len(calls) == 6 + 8


# ------------------------------------------------------------------ the video pipelines
class _JaxStub(JaxBase):
    image_size = 16

    def __init__(self):
        self.calls = []

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, key=None):
        self.calls.append((round(float(t_start), 4), round(float(t_end), 4)))
        return jnp.clip(img * 0.9 + 0.1 * t_start - 0.02, -1, 1)


class _TorchStub(BaseDiffusionProcessor):
    image_size = 16
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def forward(self, img, prompts, t_start, t_end=1.0, verbose=True, **kw):
        self.calls.append((round(float(t_start), 4), round(float(t_end), 4)))
        return torch.clamp(img * 0.9 + 0.1 * t_start - 0.02, -1, 1)


def _jax_draws(shape, random_init: bool, key=None):
    """maua_tpu's video draws in order: the random init's (from the key itself), then each diffused frame's
    noise injection (from a split)."""
    key = jax.random.PRNGKey(0) if key is None else key
    if random_init:
        yield np.asarray(jax.random.normal(key, shape))
    while True:
        key, sub = jax.random.split(key)
        yield np.asarray(jax.random.normal(sub, shape))


@pytest.mark.parametrize("options", [
    dict(), dict(turbo=2), dict(wrap_around=2, first_skip=0.2), dict(turbo=2, wrap_around=1),
    dict(hist_persist=True, flow_exaggeration=1.5), dict(first_frame_init=True, consistency_trust=0.0),
    dict(init_type="random", blend=0.0, loop_fade=0.5), dict(noise_injection=0.0, constant_seed=3),
])
def test_video_flow_diffusion_matches_with_a_stub(clip, workspaces, tmp_path, monkeypatch, options):
    options = dict(options)
    if options.pop("first_frame_init", False):
        path = tmp_path / "first.png"
        from PIL import Image

        Image.fromarray((np.random.RandomState(73).rand(20, 20, 3) * 255).astype(np.uint8)).save(path)
        options["first_frame_init"] = str(path)
    if options.get("hist_persist"):  # the port's histogram matching takes maua_tpu's jitter
        real = TVID.match_histogram
        monkeypatch.setattr(TVID, "match_histogram",
                            lambda t, s: real(t, s, noise=iter(jax_jitter(t.shape, [s.shape]))))
    kw = dict(text="a fox", size=(16, 16), skip=0.6, verbose=False, **options)
    jstub, tstub = _JaxStub(), _TorchStub()
    want = JVID.VideoFlowDiffusionProcessor()(jstub, clip, **kw)
    draws = _jax_draws((1, 16, 16, 3), options.get("init_type") == "random")
    got = TVID.VideoFlowDiffusionProcessor()(tstub, clip, draws=draws, **kw)
    assert got.shape == want.shape and tstub.calls == jstub.calls
    _close(got, want, 1e-5)
    assert np.abs(got[0] - got[1]).max() > 1e-3
    if not options.get("turbo") and not options.get("wrap_around"):
        # the reference's loop-closing fill (its last turbo step, at blend weight 1 with turbo 1) copies the
        # first frame over the last; the port keeps that until it is chosen otherwise (ROADMAP.md C9)
        np.testing.assert_array_equal(got[-1], got[0])


def test_video_flow_diffusion_matches_with_stable_diffusion(clip, workspaces):
    jkw, tkw = _sd_kwargs(make_sd_params())
    kw = dict(sampler="lms", timesteps=5, cfg_scale=4.0, image_size=32)
    jsd, tsd = JaxSD(**jkw, **kw), StableDiffusion(**tkw, **kw)
    opts = dict(text="a fox", size=(32, 32), skip=0.6, first_skip=0.4, max_frames=3, verbose=False)
    want = JVID.VideoFlowDiffusionProcessor()(jsd, clip, **opts)
    key, frame_noises, draws = jax.random.PRNGKey(0), [], []
    for f_n in range(3):  # replay the key chain: the noise injection's split, then the frame's key
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (1, 32, 32, 3))))
        frame_key = jax.random.fold_in(key, f_n)
        frame_noises.append(np.asarray(jax.random.normal(jax.random.split(frame_key)[0], (1, 16, 16, 4))))
    got = TVID.VideoFlowDiffusionProcessor()(tsd, clip, draws=iter(draws), frame_noises=frame_noises, **opts)
    assert got.shape == want.shape == (3, 32, 32, 3)
    print(f"video SD: max abs err {np.abs(got - want).max():.3g}, PSNR {_psnr(got, want):.1f} dB")
    assert _psnr(got, want) >= 40.0 and np.abs(want).max() > 0.05
    files = sorted(p.name for p in (workspaces[1]).iterdir() if "diffused" in p.name)
    assert files == [f"{clip.split('/')[-1][:-4]}_diffused_{i:06d}.npy" for i in range(3)]  # the frame store


def _jax_rolls(n, n_passes, calls_per_pass, key=None):
    key = jax.random.PRNGKey(0) if key is None else key
    rolls = []
    for calls in calls_per_pass[:n_passes]:
        key, k_roll = jax.random.split(key)
        rolls.append(int(jax.random.randint(k_roll, (), 1, max(n, 2))))
        for _ in range(calls):
            key, _ = jax.random.split(key)
    return rolls


@pytest.mark.parametrize("options,passes,calls", [
    (dict(timesteps=10, skip=0.4, blend_every=3), 2, 4),
    (dict(timesteps=10, skip=0.6, turbo=2), 1, 2),
    (dict(timesteps=20, skip=0.5, blend_every=0.2, consistency_trust=0.3, blend=1.0), 3, 4),
])
def test_loop_direct_matches_with_a_stub(clip, workspaces, options, passes, calls):
    jstub, tstub = _JaxStub(), _TorchStub()
    want = JLD.loop_direct_sample(jstub, clip, text="x", size=(16, 16), verbose=False, **options)
    rolls = _jax_rolls(4, passes, [calls] * passes)
    got = TLD.loop_direct_sample(tstub, clip, text="x", size=(16, 16), verbose=False, rolls=rolls, **options)
    assert len(jstub.calls) == passes * calls and tstub.calls == jstub.calls
    assert got.shape == want.shape == (4, 16, 16, 3)
    _close(got, want, 1e-5)
    drawn = TLD.loop_direct_sample(_TorchStub(), clip, size=(16, 16), verbose=False, seed=1, **options)
    assert drawn.shape == got.shape and np.isfinite(drawn).all()

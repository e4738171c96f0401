"""The port's RIFE frame interpolation (maua_tpu_torch/super/rife.py) and the
video entry points (super/video.py) against maua_tpu's, on the CPU in f32.

RIFE with base 8 channels and three scales on 32^2 frames, every
parameter drawn with numpy from a seed and bridged. Tolerances: the
midpoint and the rgb24 stream 1e-4 absolute on frames in [0, 1] (the
antialiased bilinear resizes, border-padded warps and convolutions sum
in other orders); the yuv420p stream within one level of 255 at a
handful of bytes, where a frame value lies within roundoff of a rounding
edge. The video functions run without an ffmpeg binary (shutil.which reports
none), so they write through OpenCV's mp4v, and the files are read back
with OpenCV: (T - 1) * factor + 1 frames for RIFE.
"""

import shutil

import numpy as np
import pytest

from maua_tpu.super import rife as JR
from maua_tpu_torch import bridge
from maua_tpu_torch.ops import video as TV
from maua_tpu_torch.super import image as TI
from maua_tpu_torch.super import rife as TR
from maua_tpu_torch.super import video as TSV
from test_torch_super import nchw, nhwc, random_params

JCFG, TCFG = JR.RIFEConfig(base_channels=8), TR.RIFEConfig(base_channels=8)


@pytest.fixture(scope="module")
def params():
    return random_params(lambda k: JR.init_params(k, JCFG), 0)


@pytest.fixture
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    assert not TV.ffmpeg_available()


def frames(t, seed=1, size=32):
    """A moving gradient with noise: frames (t, size, size, 3) in [0, 1]."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    out = [np.stack([np.sin(6 * x + i) * 0.5 + 0.5, y, np.cos(4 * y - i) * 0.5 + 0.5], -1) for i in range(t)]
    return np.clip(np.stack(out) + 0.05 * rs.randn(t, size, size, 3), 0, 1).astype(np.float32)


def test_midpoint_matches(params):
    f = frames(2)
    ref = np.asarray(JR.midpoint(params, f[:1], f[1:], JCFG))
    out = nhwc(TR.midpoint(bridge.super_params_to_torch(params), nchw(f[:1]), nchw(f[1:]), TCFG))
    assert out.shape == ref.shape == (1, 32, 32, 3)
    assert np.abs(out - ref).max() <= 1e-4
    assert np.abs(out - f[:1]).max() > 0.05  # the warps moved something


@pytest.mark.parametrize("factor", [2, 4])
def test_interpolate_matches(params, factor):
    f = frames(3)
    ported = bridge.super_params_to_torch(params)
    ref = list(JR.interpolate(f, factor=factor, params=params, cfg=JCFG))
    out = list(TR.interpolate(f, factor=factor, params=ported, cfg=TCFG, device="cpu"))
    assert len(out) == len(ref) == 2 * factor + 1
    assert np.abs(np.stack(out) - np.stack(ref)).max() <= 1e-4
    np.testing.assert_array_equal(out[0], f[0])
    ref = np.stack(list(JR.interpolate(f, factor=factor, params=params, cfg=JCFG, pix_fmt="yuv420p")))
    out = np.stack(list(TR.interpolate(f, factor=factor, params=ported, cfg=TCFG, pix_fmt="yuv420p", device="cpu")))
    assert out.shape == ref.shape == (2 * factor + 1, 48, 32) and out.dtype == np.uint8
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 8


def test_interpolate_draws_its_net_from_a_seed():
    f = frames(2, size=16)
    a = list(TR.interpolate(f, factor=2, device="cpu", seed=3))
    b = list(TR.interpolate(f, factor=2, device="cpu", seed=3))
    assert len(a) == 3 and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_video_functions_write_through_opencv(no_ffmpeg, tmp_path, monkeypatch, params):
    monkeypatch.setitem(TI.MODEL_REGISTRY, "tiny", ("rrdb", TI.rrdbnet.RRDBConfig(num_feat=8, num_block=1,
                                                                                   num_grow_ch=4)))
    src = str(tmp_path / "in.mp4")
    TV.write_video(frames(4, size=16), src, fps=8, value_range=(0, 1))
    clip, fps = TV.read_video(src)
    assert clip.shape == (4, 16, 16, 3) and abs(fps - 8) < 0.01

    up, up_fps = TV.read_video(TSV.upscale_video(src, str(tmp_path / "up.mp4"), model_name="tiny", batch_size=3,
                                                 device="cpu"))
    assert up.shape == (4, 64, 64, 3) and abs(up_fps - 8) < 0.01

    ported = bridge.super_params_to_torch(params)
    for factor, kw, want_frames, want_fps in ((2, {}, 7, 16), (4, {}, 13, 32), (2, {"decimate": 2}, 4, 8),
                                              (2, {"slower": 2}, 7, 8)):
        out = TSV.interpolate_video(src, str(tmp_path / f"x{factor}{kw}.mp4"), factor=factor, params=ported,
                                    cfg=TCFG, device="cpu", **kw)
        got, got_fps = TV.read_video(out)
        assert got.shape == (want_frames, 16, 16, 3) and abs(got_fps - want_fps) < 0.01, (factor, kw)
    assert TV.read_video(src, max_frames=2)[0].shape[0] == 2
    with pytest.raises(FileNotFoundError):
        TV.read_video(str(tmp_path / "missing.mp4"))


def test_cli_runs_super_video(no_ffmpeg, tmp_path, capsys):
    from maua_tpu_torch.__main__ import main

    src = str(tmp_path / "clip.mp4")
    TV.write_video(frames(3, size=16), src, fps=10, value_range=(0, 1))
    out = str(tmp_path / "clip_2x.mp4")
    main(["super", "video", src, "--mode", "interpolate", "-if", "2", "--device", "cpu", "--output_file", out])
    assert capsys.readouterr().out.strip() == out
    got, fps = TV.read_video(out)
    assert got.shape == (5, 16, 16, 3) and abs(fps - 20) < 0.01
    with pytest.raises(SystemExit):
        main(["super", "video", src, src, "--output_file", out, "--device", "cpu"])

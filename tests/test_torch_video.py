"""The port's frame delivery and video writing (maua_tpu_torch/ops/video.py,
the FFMPEG renderer) against maua_tpu's.

`rgb_to_yuv420` must give maua_tpu's bytes exactly: both round in f32
after each step and sum each 2x2 chroma block as two row pairs, so even
values on a rounding edge land alike. `pipelined_frames` must hand out
the frames of a plain loop, in order, honouring a padded tail. Without an
ffmpeg binary (shutil.which reports none, as on a host that has no
ffmpeg) the writer falls back to OpenCV's mp4v, as maua_tpu's does, and
the file must read back through OpenCV with the frame count and size
written.
"""

import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.ops import video as JV
from maua_tpu_torch.audiovisual.render import FFMPEG
from maua_tpu_torch.gan import stylegan2 as T2
from maua_tpu_torch.gan import wrappers as TW
from maua_tpu_torch.ops import video as TV


@pytest.fixture
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    assert not TV.ffmpeg_available()


def read_back(path):
    """(frame count, (width, height)) of a video file, decoded with OpenCV."""
    cap = cv2.VideoCapture(str(path))
    count, size = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        count += 1
        size = (frame.shape[1], frame.shape[0])
    cap.release()
    return count, size


# 2x2 blocks (row 0 then row 1, RGB) whose chroma mean lies on a rounding
# edge in f32: summed in another order than maua_tpu's, each rounds to the
# other neighbour (found by sweeping the RGB cube)
EDGE_BLOCKS = [
    [22, 145, 0, 22, 145, 3, 22, 150, 246, 22, 150, 249], [102, 3, 126, 102, 3, 129, 102, 9, 114, 102, 9, 117],
    [114, 15, 138, 114, 15, 141, 114, 21, 126, 114, 21, 129], [138, 39, 162, 138, 39, 165, 138, 45, 150, 138, 45, 153],
    [162, 63, 186, 162, 63, 189, 162, 69, 174, 162, 69, 177], [186, 87, 210, 186, 87, 213, 186, 93, 198, 186, 93, 201],
    [198, 99, 222, 198, 99, 225, 198, 105, 210, 198, 105, 213],
    [126, 227, 120, 126, 227, 123, 126, 233, 108, 126, 233, 111],
    [138, 239, 132, 138, 239, 135, 138, 245, 120, 138, 245, 123], [187, 80, 216, 187, 80, 219, 187, 86, 204, 187, 86, 207],
]


def edge_frames():
    """EDGE_BLOCKS side by side in one frame, and a frame of every grey level."""
    blocks = np.array(EDGE_BLOCKS, np.uint8).reshape(-1, 2, 2, 3)
    edges = np.concatenate(list(blocks), axis=1)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[None, :, None], 3, -1).repeat(2, 0)
    return np.stack([np.pad(edges, ((0, 0), (0, 256 - edges.shape[1]), (0, 0))), grey])


@pytest.mark.parametrize("shape", [(3, 32, 48), (1, 64, 64), (2, 2, 2)])
def test_rgb_to_yuv420_gives_maua_tpus_bytes(shape):
    b, h, w = shape
    x = np.random.RandomState(h * w).randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    out = TV.rgb_to_yuv420(torch.from_numpy(x))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (b, 3 * h // 2, w)
    np.testing.assert_array_equal(out.numpy(), np.asarray(JV.rgb_to_yuv420(jnp.asarray(x))))


def test_rgb_to_yuv420_on_rounding_edges():
    x = edge_frames()
    np.testing.assert_array_equal(TV.rgb_to_yuv420(torch.from_numpy(x)).numpy(),
                                  np.asarray(JV.rgb_to_yuv420(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(31, 32), (32, 33)])
def test_rgb_to_yuv420_refuses_odd_sizes(hw):
    x = np.zeros((1, *hw, 3), np.uint8)
    with pytest.raises(ValueError, match="even frame dimensions"):
        TV.rgb_to_yuv420(torch.from_numpy(x))
    with pytest.raises(ValueError, match="even frame dimensions"):
        JV.rgb_to_yuv420(jnp.asarray(x))


@pytest.mark.parametrize("pix_fmt", ["rgb24", "yuv420p"])
def test_pipelined_frames_hands_out_a_plain_loops_frames(pix_fmt):
    """Five batches of 3 (the last padded, 2 valid), with and without the
    (batch, n_valid) protocol: the frames of a plain loop, in order."""
    rs = np.random.RandomState(0)
    batches = [torch.from_numpy(rs.randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)) for _ in range(5)]
    valid = [3, 3, 3, 3, 2]
    want = []
    for batch, n in zip(batches, valid):
        frames = TV.rgb_to_yuv420(batch) if pix_fmt == "yuv420p" else batch
        want.extend(frames[:n].numpy())
    got = list(TV.pipelined_frames(iter(zip(batches, valid)), pix_fmt))
    assert len(got) == 14 and all(g.dtype == np.uint8 for g in got)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert len(list(TV.pipelined_frames(iter(batches), pix_fmt))) == 15
    np.testing.assert_array_equal(np.stack(list(TV.pipelined_frames(iter(batches[:1]), pix_fmt))),
                                  np.stack(want[:3]))


def test_pipelined_frames_refuses_the_unported_codec():
    """The DCT codec is ported now (tests/test_torch_framecodec.py holds it against maua_tpu's): "dct" renders
    I420 frames, the I420 of the batch; a pix_fmt the port does not know is still refused."""
    black = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    frames = list(TV.pipelined_frames(iter([black]), "dct"))
    assert len(frames) == 1 and np.array_equal(frames[0], TV.rgb_to_yuv420(black)[0].numpy())
    with pytest.raises(ValueError, match="pix_fmt"):
        next(TV.pipelined_frames(iter([torch.zeros(1, 16, 16, 3, dtype=torch.uint8)]), "nv12"))


@pytest.mark.parametrize("pix_fmt", ["rgb24", "yuv420p"])
def test_writer_falls_back_to_opencv_without_ffmpeg(no_ffmpeg, tmp_path, capsys, pix_fmt):
    """C7: with no ffmpeg binary, write_video (float frames in [-1, 1]) and
    VideoWriter (uint8 frames, raw I420 bytes) write mp4 files that read
    back with the frame count and size written; an audio file is named in
    a warning, not muxed."""
    rs = np.random.RandomState(1)
    frames = rs.uniform(-1, 1, (5, 32, 48, 3)).astype(np.float32)
    path = tmp_path / "float.mp4"
    TV.write_video(frames, str(path), fps=12, audio_file="song.wav", pix_fmt="rgb24")
    assert "WITHOUT the audio track song.wav" in capsys.readouterr().out
    assert read_back(path) == (5, (48, 32))

    uint8 = rs.randint(0, 256, (7, 32, 48, 3)).astype(np.uint8)
    path = tmp_path / f"{pix_fmt}.mp4"
    with TV.VideoWriter(str(path), (48, 32), fps=24, pix_fmt=pix_fmt) as video:
        if pix_fmt == "yuv420p":
            for f in TV.rgb_to_yuv420(torch.from_numpy(uint8)).numpy():
                video.write(f.tobytes())
        else:
            video.write(uint8)
    assert read_back(path) == (7, (48, 32))


def test_writer_without_ffmpeg_refuses_other_formats(no_ffmpeg, tmp_path):
    for fmt in ("dct", "nv12"):
        with pytest.raises(ValueError, match="requires the ffmpeg rawvideo pipe"):
            TV.VideoWriter(str(tmp_path / "x.mp4"), (32, 32), pix_fmt=fmt)


@pytest.mark.parametrize("output_size,pix_fmt", [(None, None), (None, "rgb24"), ((30, 21), None)],
                         ids=["yuv420p-default", "rgb24", "odd-size-falls-back-to-rgb24"])
def test_ffmpeg_renderer_end_to_end_without_ffmpeg(no_ffmpeg, tmp_path, output_size, pix_fmt):
    """The FFMPEG renderer over a 32^2 StyleGAN2 on the CPU, 10 frames in
    batches of 4 (a padded tail): I420 delivery by default, rgb24 on
    request, and odd frame sizes (30 x 21) fall back to rgb24, padded by a
    black row to 30 x 22 as the ffmpeg pipe pads them."""
    cfg = T2.SG2Config(img_resolution=32, channel_base=256, channel_max=32, z_dim=32, w_dim=32, mapping_layers=2)
    model = TW.StyleGAN2(cfg=cfg, params=T2.init_params(cfg, torch.Generator().manual_seed(0)), device="cpu",
                         output_size=output_size)
    latents = model.get_w_latents("0-10")
    path = tmp_path / "out.mp4"
    renderer = FFMPEG(str(path), fps=24, audio_file=None, batch_size=4, pix_fmt=pix_fmt)
    assert renderer.batch_size == 4 and FFMPEG(str(path)).batch_size == 32
    assert renderer(model.render, {"latent_w_plus": latents}) == str(path)
    assert read_back(path) == (10, (30, 22) if output_size else (32, 32))

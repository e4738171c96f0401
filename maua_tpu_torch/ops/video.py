"""Frame delivery and video writing: on-device I420 conversion, pipelined
device-to-host copies, an ffmpeg rawvideo pipe with audio muxing, and an
OpenCV writer where there is no ffmpeg binary.

Port of `maua_tpu/ops/video.py` (ffmpeg_available, rgb_to_yuv420,
pipelined_frames, WriteWorker, _CV2Worker, VideoWriter, write_video).
On a CUDA tensor `pipelined_frames` overlaps the synthesis of the next
batch with the copy of this one: each batch goes to a reused pinned host
buffer on a copy stream that an event orders after the compute stream,
and its frames are handed out once the copy's event has completed.
The `dct` delivery format (the reference's `ops/framecodec.py`) is not
ported yet.
"""

from __future__ import annotations

import collections
import os
import queue
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# batches in flight behind the one being handed out, as in maua_tpu
PIPELINE_DEPTH = 2


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def rgb_to_yuv420(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> planar I420 on the frames' device: (B, H, W, 3) uint8 ->
    (B, 3H/2, W) uint8 (BT.601 limited range, 2x2 mean chroma), the byte
    layout ffmpeg reads as ``-pix_fmt yuv420p`` rawvideo; half the bytes
    of rgb24 to copy to the host. Each step rounds in f32 as maua_tpu's
    does, so the bytes are the same."""
    B, H, W, _ = rgb.shape
    if H % 2 or W % 2:
        raise ValueError(f"yuv420p needs even frame dimensions, got {H}x{W}")
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    luma = 16.0 + y * (219.0 / 255.0)
    cb = 128.0 + (b - y) * (224.0 / 255.0 * 0.5 / (1.0 - 0.114))
    cr = 128.0 + (r - y) * (224.0 / 255.0 * 0.5 / (1.0 - 0.299))

    def sub(c):  # the mean of each 2x2 block, summed by rows as XLA sums it
        return ((c[:, 0::2, 0::2] + c[:, 0::2, 1::2]) + (c[:, 1::2, 0::2] + c[:, 1::2, 1::2])) * 0.25

    def to8(p):
        return p.round().clamp(0, 255).to(torch.uint8).reshape(B, -1)

    return torch.cat([to8(luma), to8(sub(cb)), to8(sub(cr))], dim=1).reshape(B, 3 * H // 2, W)


class _PinnedCopies:
    """Device-to-host copies of frame batches into reused pinned buffers,
    on a copy stream that waits for the compute stream by an event."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device=device)
        self.free: Dict[Tuple, List[torch.Tensor]] = collections.defaultdict(list)

    def start(self, batch: torch.Tensor):
        """Enqueue the copy of `batch`; returns (host buffer, done event)."""
        batch = batch.contiguous()
        key = (tuple(batch.shape), batch.dtype)
        host = self.free[key].pop() if self.free[key] else torch.empty(batch.shape, dtype=batch.dtype,
                                                                         pin_memory=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(batch.device))
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            host.copy_(batch, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        batch.record_stream(self.stream)  # the allocator keeps the batch until the copy has read it
        return host, done

    def finish(self, host: torch.Tensor, done: torch.cuda.Event, n: int) -> np.ndarray:
        """Wait for the copy, take the first n frames out of the buffer and
        give the buffer back for reuse."""
        done.synchronize()
        frames = torch.empty((n, *host.shape[1:]), dtype=host.dtype)
        frames.copy_(host[:n])  # torch's copy spreads over the host's cores, numpy's takes one
        self.free[(tuple(host.shape), host.dtype)].append(host)
        return frames.numpy()


def pipelined_frames(batches, pix_fmt: str = "rgb24"):
    """Yield the uint8 frames of device batches in order, PIPELINE_DEPTH
    batches behind the one being synthesized.

    `batches` yields (B, H, W, 3) uint8 tensors, or (batch, n_valid)
    tuples whose first n_valid frames count (a padded tail). With
    pix_fmt="yuv420p" each batch is converted to planar I420 on its device
    first (rgb_to_yuv420) and the frames are (3H/2, W). A CUDA batch is
    copied to the host through pinned buffers on a copy stream, so
    synthesis of the next batches overlaps the copy; a CPU batch is handed
    out as it is."""
    if pix_fmt == "dct":
        raise NotImplementedError("pix_fmt='dct' needs the frame codec (maua_tpu's ops/framecodec.py), "
                                  "which is not ported yet; use 'yuv420p' or 'rgb24'")
    if pix_fmt not in ("rgb24", "yuv420p"):
        raise ValueError(f"unknown pix_fmt {pix_fmt!r}")
    copies = None
    pending: "collections.deque" = collections.deque()

    def emit(item):
        frames, n, done = item
        if done is None:
            frames = frames[:n].numpy()
        else:
            frames = copies.finish(frames, done, n)
        yield from frames

    for item in batches:
        batch, n = item if isinstance(item, tuple) else (item, None)
        if pix_fmt == "yuv420p":
            batch = rgb_to_yuv420(batch)
        n = batch.shape[0] if n is None else n
        if batch.is_cuda:
            if copies is None:
                copies = _PinnedCopies(batch.device)
            host, done = copies.start(batch)
            pending.append((host, n, done))
        else:
            pending.append((batch, n, None))
        if len(pending) > PIPELINE_DEPTH:
            yield from emit(pending.popleft())
    while pending:
        yield from emit(pending.popleft())


class WriteWorker(threading.Thread):
    """Drains a queue of raw frames into an ffmpeg rawvideo pipe (H.264,
    yuv420p), muxed with the audio when one is given."""

    def __init__(
        self,
        output_file: str,
        output_size: Tuple[int, int],
        fps: float,
        audio_file: Optional[str] = None,
        audio_offset: float = 0.0,
        audio_duration: Optional[float] = None,
        ffmpeg_preset: str = "slow",
        crf: int = 17,
        pix_fmt: str = "rgb24",
    ):
        super().__init__(daemon=True)
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=64)
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        w, h = output_size
        cmd = ["ffmpeg", "-y", "-v", "warning"]
        cmd += ["-f", "rawvideo", "-pix_fmt", pix_fmt, "-s", f"{w}x{h}", "-r", str(fps), "-i", "-"]
        if audio_file is not None:
            if audio_offset:
                cmd += ["-ss", str(audio_offset)]
            cmd += ["-i", audio_file]
            if audio_duration is not None:
                cmd += ["-t", str(audio_duration)]
            cmd += ["-map", "0:v", "-map", "1:a", "-c:a", "aac", "-shortest"]
        if pix_fmt == "rgb24":
            # yuv420p output needs even dimensions: pad odd inputs by one black
            # row or column (yuv420p input is even by construction)
            cmd += ["-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2"]
        cmd += ["-c:v", "libx264", "-preset", ffmpeg_preset, "-crf", str(crf), "-pix_fmt", "yuv420p", output_file]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)

    def run(self):
        broken = False
        while True:
            item = self.q.get()
            if item is None:
                break
            if broken:
                continue  # keep draining so that writers do not block
            try:
                self.proc.stdin.write(item)
            except (BrokenPipeError, OSError):
                broken = True
        try:
            self.proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass
        self.proc.wait()

    def write(self, frame_bytes: bytes):
        self.q.put(frame_bytes)

    def close(self):
        self.q.put(None)
        self.join()
        if self.proc.returncode not in (0, None):
            raise RuntimeError(f"ffmpeg exited with code {self.proc.returncode}")


class _CV2Worker:
    """The writer where there is no ffmpeg binary: mp4v through OpenCV,
    without the audio track. Takes rgb24 or planar yuv420p frames. Odd
    rgb24 frames get one black row or column, as the ffmpeg pipe pads
    them (OpenCV's encoder would drop it; maua_tpu's fallback does)."""

    def __init__(self, output_file: str, output_size: Tuple[int, int], fps: float,
                 audio_file: Optional[str] = None, pix_fmt: str = "rgb24", **_):
        import cv2

        if audio_file is not None:
            print(f"warning: no ffmpeg binary found — writing {output_file} WITHOUT the audio track {audio_file}")
        self.cv2 = cv2
        self.size = output_size
        self.pix_fmt = pix_fmt
        w, h = output_size
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        self.writer = cv2.VideoWriter(output_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w + w % 2, h + h % 2))

    def start(self):
        pass

    def write(self, frame_bytes: bytes):
        w, h = self.size
        if self.pix_fmt == "yuv420p":
            yuv = np.frombuffer(frame_bytes, np.uint8).reshape(h * 3 // 2, w)
            self.writer.write(self.cv2.cvtColor(yuv, self.cv2.COLOR_YUV2BGR_I420))
            return
        frame = np.frombuffer(frame_bytes, np.uint8).reshape(h, w, 3)
        frame = np.pad(frame, ((0, h % 2), (0, w % 2), (0, 0)))
        self.writer.write(self.cv2.cvtColor(frame, self.cv2.COLOR_RGB2BGR))

    def close(self):
        self.writer.release()


class VideoWriter:
    """Context-managed threaded writer: ffmpeg when its binary is on PATH,
    else OpenCV (rgb24 and yuv420p only).

    write() takes raw frame bytes, or (H, W, C) / (T, H, W, C) arrays:
    uint8 as they are, other dtypes scaled from `value_range`."""

    def __init__(
        self,
        output_file: str,
        output_size: Tuple[int, int],
        fps: float = 24,
        audio_file: Optional[str] = None,
        audio_offset: float = 0.0,
        audio_duration: Optional[float] = None,
        value_range: Tuple[float, float] = (-1.0, 1.0),
        pix_fmt: str = "rgb24",
        **kwargs,
    ):
        self.value_range = value_range
        have_ffmpeg = ffmpeg_available()
        if pix_fmt not in ("rgb24", "yuv420p") and not have_ffmpeg:
            raise ValueError(f"pix_fmt={pix_fmt!r} requires the ffmpeg rawvideo pipe (no ffmpeg binary found)")
        cls = WriteWorker if have_ffmpeg else _CV2Worker
        self.worker = cls(output_file, output_size, fps, audio_file=audio_file, audio_offset=audio_offset,
                          audio_duration=audio_duration, pix_fmt=pix_fmt, **kwargs)
        self.worker.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def write(self, frame):
        if isinstance(frame, bytes):
            self.worker.write(frame)
            return
        arr = np.asarray(frame)
        if arr.ndim == 4:
            for f in arr:
                self.write(f)
            return
        if arr.dtype != np.uint8:
            mn, mx = self.value_range
            arr = (np.clip(arr, mn, mx) - mn) / (mx - mn)
            arr = np.round(arr * 255).astype(np.uint8)
        self.worker.write(arr.tobytes())

    def close(self):
        self.worker.close()


def write_video(frames, output_file: str, fps: float = 24, value_range=(-1, 1), audio_file=None, **kw):
    """Write a (T, H, W, C) array to a video file."""
    frames = np.asarray(frames)
    t, h, w, _ = frames.shape
    with VideoWriter(output_file, (w, h), fps, audio_file=audio_file, value_range=value_range, **kw) as v:
        for f in frames:
            v.write(f)

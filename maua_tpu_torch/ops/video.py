"""Frame delivery and video writing: on-device I420 conversion, pipelined
device-to-host copies, an ffmpeg rawvideo pipe with audio muxing, and an
OpenCV writer where there is no ffmpeg binary.

Port of `maua_tpu/ops/video.py` (ffmpeg_available, rgb_to_yuv420,
pipelined_frames, WriteWorker, _CV2Worker, VideoWriter, write_video,
read_video).
On a CUDA tensor `pipelined_frames` overlaps the synthesis of the next
batch with the copy of this one: each batch goes to a reused pinned host
buffer on a copy stream that an event orders after the compute stream,
and its frames are handed out once the copy's event has completed. With
`pix_fmt="dct"` each batch is encoded on its device by the DCT frame codec
(`ops/framecodec.py`), only the packed bytes are copied, and the host's C++
decoder turns each chunk back into I420 frames.
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


# leading-axis slices a fetch is split into (presplit): maua_tpu's count of parallel streams; on the card each
# slice is one copy on the copy stream
FETCH_STREAMS = 8


def presplit(arr: torch.Tensor, n_streams: Optional[int] = None) -> List[torch.Tensor]:
    """Split a tensor into leading-axis slices for fetch_slices, when the producing work is enqueued (views:
    nothing is copied yet). Below 1 MiB, or with one stream, the tensor stays whole."""
    n = min(FETCH_STREAMS if n_streams is None else n_streams, arr.shape[0] if arr.dim() else 1)
    if n <= 1 or arr.numel() * arr.element_size() < (1 << 20):
        return [arr]
    bounds = np.linspace(0, arr.shape[0], n + 1).astype(int)
    return [arr[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def submit_fetches(slices, copies: Optional[_PinnedCopies] = None) -> list:
    """Start copying each slice to the host now: a CUDA slice into a pinned buffer of `copies` (made for the
    call when none is given; the dct route passes its own, whose buffers it reuses) on its copy stream,
    ordered after the work enqueued so far; a CPU slice as it is. Returns the pending copies for
    gather_fetches."""
    pending = []
    for s in slices:
        if s.is_cuda:
            copies = copies or _PinnedCopies(s.device)
            pending.append((copies, *copies.start(s)))
        else:
            pending.append((None, s, None))
    return pending


def gather_fetches(pending) -> np.ndarray:
    """Wait for submitted copies and join them along the leading axis."""
    parts = [host.detach().numpy() if copies is None else copies.finish(host, done, host.shape[0])
             for copies, host, done in pending]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def fetch_slices(slices) -> np.ndarray:
    """Copy presplit slices to the host and join them."""
    return gather_fetches(submit_fetches(slices))


def fetch_parallel(arr: torch.Tensor, n_streams: Optional[int] = None) -> np.ndarray:
    """presplit and fetch_slices in one call."""
    return fetch_slices(presplit(arr, n_streams))


def pipelined_frames(batches, pix_fmt: str = "rgb24", codec_quality: float = 1.0):
    """Yield the uint8 frames of device batches in order, PIPELINE_DEPTH
    batches behind the one being synthesized.

    `batches` yields (B, H, W, 3) uint8 tensors, or (batch, n_valid)
    tuples whose first n_valid frames count (a padded tail). With
    pix_fmt="yuv420p" each batch is converted to planar I420 on its device
    first (rgb_to_yuv420) and the frames are (3H/2, W). With pix_fmt="dct"
    each batch is one chunk of the DCT frame codec, encoded on its device
    and decoded on the host (`_dct_pipelined_frames`; `codec_quality`
    scales its quantization step), and the frames are I420 as well. A CUDA
    batch is copied to the host through pinned buffers on a copy stream,
    so synthesis of the next batches overlaps the copy; a CPU batch is
    handed out as it is."""
    if pix_fmt == "dct":
        yield from _dct_pipelined_frames(batches, codec_quality)
        return
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


def _dct_pipelined_frames(batches, quality: float):
    """The dct delivery: each batch is one chunk of the DCT frame codec (frame 0 intra, the rest closed-loop
    deltas). The plan is calibrated on the first batch by statistics computed on its device
    (`framecodec.calibrate_chunk_device`); every batch is then encoded on its device, its packed bytes and
    its clip error are copied (intra and the delta stream's presplit slices), and the host's C++ decoder
    turns it back into I420 frames, PIPELINE_DEPTH chunks behind the one being encoded. Frames that are not
    16-aligned go the yuv420p way instead.

    A chunk whose plan does not hold it (clipping added more than CLIP_MSE_SHARE of the quantizer's own
    error, qstep^2 / 12, to a plane of a frame) is encoded again before it is decoded: under the route's newer
    plan if that holds it, else under a plan calibrated on the chunk itself, which the route keeps from then
    on. maua_tpu keeps the first batch's plan and clips: on the e2e clip, whose later batches want more
    escapes than the first batch's capacity, frames fell to 24 dB."""
    import itertools

    from . import framecodec as fc

    it = iter(batches)
    first = next(it, None)
    if first is None:
        return
    fbatch = first[0] if isinstance(first, tuple) else first
    H, W = fbatch.shape[1], fbatch.shape[2]
    if H % 16 or W % 16:
        yield from pipelined_frames(itertools.chain([first], it), "yuv420p")
        return
    plan = [fc.calibrate_chunk_device(fbatch, quality=quality)]  # the route's current plan
    copies = _PinnedCopies(fbatch.device) if fbatch.is_cuda else None
    pending: "collections.deque" = collections.deque()
    for item in itertools.chain([first], it):
        batch, n = item if isinstance(item, tuple) else (item, None)
        intra, deltas, clip_mse = fc.encode_chunk(batch, plan[0], clip_error=True)
        fetches = [submit_fetches(part, copies) for part in ([intra], [clip_mse.reshape(1)], presplit(deltas))]
        pending.append((fetches, batch.shape[0] if n is None else n, batch, plan[0]))
        if len(pending) > PIPELINE_DEPTH:
            yield from _emit_chunk(pending.popleft(), plan, quality, copies)
    while pending:
        yield from _emit_chunk(pending.popleft(), plan, quality, copies)


# the share of the quantizer's own mean squared error (qstep^2 / 12) that clipping may add to a plane of a frame
# before the dct route encodes the chunk again under a plan that holds it (a quarter: about 1 dB at most)
CLIP_MSE_SHARE = 0.25


def _emit_chunk(item, plan: list, quality: float, copies: Optional[_PinnedCopies]):
    """Wait for a chunk's copies (a chunk its plan does not hold encoded again, see _dct_pipelined_frames),
    decode it with the native decoder and yield its first n frames."""
    from . import framecodec as fc

    (intra_f, clip_f, deltas_f), n, batch, codec = item

    def holds(mse, c):
        return float(mse) <= CLIP_MSE_SHARE * max(c.delta.qstep_y, c.delta.qstep_c) ** 2 / 12.0

    if not holds(gather_fetches(clip_f)[0], codec):
        held = False
        if plan[0] is not codec:  # a newer plan: whether it holds this chunk
            codec = plan[0]
            intra, deltas, clip_mse = fc.encode_chunk(batch, codec, clip_error=True)
            held = holds(clip_mse, codec)
        if not held:
            codec = plan[0] = fc.calibrate_chunk_device(batch, quality=quality)
            intra, deltas = fc.encode_chunk(batch, codec)
        intra_f, deltas_f = submit_fetches([intra], copies), submit_fetches(presplit(deltas), copies)
    frames = fc.decode_chunk(gather_fetches(intra_f), gather_fetches(deltas_f), codec)
    yield from frames[:n]


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


def read_video(path: str, max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Decode a video with OpenCV to (T, H, W, 3) float32 RGB in [0, 1] and its fps."""
    import cv2

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames is not None and len(frames) >= max_frames):
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"could not decode any frames from {path!r}")
    return np.stack(frames).astype(np.float32) / 255.0, fps

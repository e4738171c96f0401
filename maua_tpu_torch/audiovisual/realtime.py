"""Realtime viewer: frames of a momentum random walk in W, streamed to a
window or to a callback.

Port of `maua_tpu/audiovisual/realtime.py` (RealtimeModule, run_realtime).
The walk and the synthesis stay on the device; the frames reach the host
through `ops.video.pipelined_frames`, which copies one frame while the
next ones are synthesized. A render thread fills a small queue; the
caller's thread shows each frame in an OpenCV window or hands it to
`frame_callback`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch


class RealtimeModule:
    """A smooth random walk in W: each step takes a standard-normal draw n,
    v <- momentum v + (1 - momentum) n and w <- w + step_size v, and
    synthesizes w (1, num_ws, w_dim) into a uint8 frame (H, W, 3).

    `draw(shape)` makes the walk's draws in maua_tpu's order: the start w,
    then one per step. By default they come from `gen` (seed 0 on `device`
    when None); a caller that hands `draw` in replays another walk."""

    def __init__(self, synthesizer: Callable, num_ws: int, w_dim: int, momentum: float = 0.95,
                 step_size: float = 0.05, gen: Optional[torch.Generator] = None, device=None,
                 draw: Optional[Callable] = None):
        self.synthesizer = synthesizer
        if draw is None:
            gen = gen if gen is not None else torch.Generator(device=device or "cuda").manual_seed(0)

            def draw(shape):
                return torch.randn(shape, generator=gen, device=gen.device)

        self.draw = draw
        self.w = draw((1, num_ws, w_dim))
        self.v = torch.zeros_like(self.w)
        self.momentum = momentum
        self.step_size = step_size
        self._frames = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Advance the walk once; the frame (1, H, W, 3) uint8 on the device."""
        noise = self.draw(self.w.shape)
        self.v = self.momentum * self.v + (1 - self.momentum) * noise
        self.w = self.w + self.step_size * self.v
        img = self.synthesizer(self.w)  # (1, C, H, W) in [-1, 1]
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)

    def frame(self) -> np.ndarray:
        """The next frame (H, W, 3) uint8 on the host, a few steps behind the walk."""
        if self._frames is None:
            from ..ops.video import pipelined_frames

            def walk():
                while True:
                    yield self.step()

            self._frames = pipelined_frames(walk())
        return next(self._frames)


def run_realtime(
    synthesizer: Callable,
    num_ws: int,
    w_dim: int,
    frame_callback: Optional[Callable] = None,
    max_frames: Optional[int] = None,
    window_name: str = "maua-tpu",
    target_fps: float = 30.0,
    gen: Optional[torch.Generator] = None,
    device=None,
) -> int:
    """Show the walk's frames until `max_frames` (or "q" in the window):
    in an OpenCV window, or through frame_callback(frame) paced at
    target_fps. A render thread fills a queue of four frames; an error
    there is raised here. Returns the frames shown."""
    module = RealtimeModule(synthesizer, num_ws, w_dim, gen=gen, device=device)
    q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            n = 0
            while not stop.is_set() and (max_frames is None or n < max_frames):
                put(module.frame())
                n += 1
            put(None)
        except Exception as e:  # noqa: BLE001 - handed to the caller's thread, which raises it
            put(e)

    use_cv2 = frame_callback is None
    if use_cv2:
        import cv2
    render = threading.Thread(target=producer, daemon=True)
    render.start()
    interval = 1.0 / target_fps
    shown = 0
    try:
        while True:
            frame = q.get()
            if frame is None:
                break
            if isinstance(frame, Exception):
                raise frame
            shown += 1
            if use_cv2:
                cv2.imshow(window_name, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
                if cv2.waitKey(max(int(interval * 1000), 1)) & 0xFF == ord("q"):
                    break
            else:
                frame_callback(frame)
                time.sleep(interval)
    finally:
        stop.set()
        render.join(timeout=60)
        if use_cv2:
            cv2.destroyAllWindows()
    return shown

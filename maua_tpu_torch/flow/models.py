"""Optical flow estimators.

Port of `maua_tpu/flow/models.py`'s `farneback_flow` only (OpenCV's
Farneback on the host, the reference's default estimator); the rest of
`flow/*` is not ported yet.
"""

from __future__ import annotations

import numpy as np


def farneback_flow(frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
    """OpenCV Farneback flow between two (H, W, 3) RGB frames in [0, 1]
    (float; uint8 frames are taken as already scaled to [0, 255]) ->
    (H, W, 2) float32 in pixels."""
    import cv2

    def gray(frame):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (frame * 255).astype(np.uint8)
        return cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)

    return cv2.calcOpticalFlowFarneback(
        gray(frame1), gray(frame2), None, pyr_scale=0.5, levels=5, winsize=15, iterations=3, poly_n=5,
        poly_sigma=1.2, flags=0,
    ).astype(np.float32)

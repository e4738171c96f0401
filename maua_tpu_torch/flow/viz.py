"""Flow file IO and visualization, on the host.

Port of `maua_tpu/flow/viz.py` (read_flo, write_flo, flow_to_image):
Middlebury `.flo` files and the Middlebury colour coding of a flow field
(hue for direction, saturation for magnitude normalized to the field's
largest radius, darkened beyond it, unknown vectors black). numpy only.
"""

from __future__ import annotations

import numpy as np

_FLO_MAGIC = 202021.25


def read_flo(filename: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{filename}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    if data.size != 2 * w * h:
        raise ValueError(f"{filename}: truncated .flo ({data.size} of {2 * w * h} floats)")
    return data.reshape(h, w, 2)


def write_flo(flow: np.ndarray, filename: str) -> None:
    """Write (H, W, 2) flow as a Middlebury .flo file."""
    flow = np.ascontiguousarray(np.asarray(flow, np.float32))
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"expected (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(filename, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.tofile(f)


def _color_wheel() -> np.ndarray:
    """(55, 3) Middlebury colour wheel: RY, YG, GC, CB, BM and MR ramps."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    for n, (a, b, rising) in [(ry, (0, 1, True)), (yg, (1, 0, False)), (gc, (1, 2, True)), (cb, (2, 1, False)),
                              (bm, (2, 0, True)), (mr, (0, 2, False))]:
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, a if rising else b] = 255 if rising else 255 - ramp
        wheel[col : col + n, b if rising else a] = ramp if rising else 255
        col += n
    return wheel


def flow_to_image(flow: np.ndarray, unknown_thresh: float = 1e7) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury colour coding."""
    flow = np.asarray(flow, np.float64)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    unknown = (np.abs(u) > unknown_thresh) | (np.abs(v) > unknown_thresh) | np.isnan(u) | np.isnan(v)
    u[unknown] = 0.0
    v[unknown] = 0.0
    rad = np.sqrt(u * u + v * v)
    maxrad = max(rad.max(initial=0.0), -1)
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    rad = np.sqrt(u * u + v * v)

    wheel = _color_wheel()
    ncols = wheel.shape[0]
    fk = (np.arctan2(-v, -u) / np.pi + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0] / 255 + f * wheel[k1] / 255
    col = np.where((rad <= 1)[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    return np.floor(255.0 * col * ~unknown[..., None]).astype(np.uint8)

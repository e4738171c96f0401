"""Training data pipeline: image folder -> cached array store -> augmented batches on the device.

Port of `maua_tpu/gan/data.py`: a one-time `.npy` cache of center-cropped,
resized images (optionally through a JPEG round trip), host-side data
augmentations (OpenCV flips, crops and rotations on a numpy Generator, so
the same seed gives maua_tpu's images), an epoch iterator over the
memory-mapped cache whose background thread decodes and stages the next
batches through pinned host memory, and the ADA-style batch augmentation
(flip, integer roll, brightness) on the device. Batches are NCHW f32 in
[-1, 1].
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..utility import resolve_device

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def build_cache(input_dir: str, resolution: int, cache_file: Optional[str] = None,
                cache_dir: Optional[str] = None, jpeg_quality: int = 0) -> str:
    """Decode, center-crop and resize every image under input_dir once into one `.npy` (uint8 NHWC),
    returned by path; an existing cache is reused. `cache_dir` relocates it; `jpeg_quality` > 0
    round-trips each image through JPEG at that quality first."""
    from PIL import Image

    if cache_file is None:
        base = cache_dir or input_dir
        os.makedirs(base, exist_ok=True)
        q = f"_q{jpeg_quality}" if jpeg_quality else ""
        stem = Path(input_dir).name if cache_dir else ""
        cache_file = os.path.join(base, f"cache_{stem}{q}_{resolution}.npy".replace("__", "_"))
    if os.path.exists(cache_file):
        return cache_file
    paths = sorted(p for p in Path(input_dir).rglob("*") if p.suffix.lower() in IMAGE_EXTS)
    if not paths:
        raise FileNotFoundError(f"no images under {input_dir}")
    arrs = []
    for p in paths:
        im = Image.open(p).convert("RGB")
        w, h = im.size
        s = min(w, h)
        im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2)).resize((resolution, resolution))
        if jpeg_quality:
            import io

            buf = io.BytesIO()
            im.save(buf, format="JPEG", quality=jpeg_quality)
            buf.seek(0)
            im = Image.open(buf).convert("RGB")
        arrs.append(np.asarray(im, np.uint8))
    np.save(cache_file, np.stack(arrs))
    return cache_file


def make_data_augment(resolution: int, hflip: bool = False, vflip: bool = False,
                      random_crop: bool = False, crop_zoom: float = float(np.sqrt(2)),
                      crop_ratio: float = 0.1, random_rotate: bool = False,
                      rotate_degrees: float = 360.0):
    """Host-side data augmentations (visible in the output data): rotation, random resized crop with
    zoom and aspect jitter, area resize, flips. Returns f(uint8 (B, H, W, 3), numpy Generator) ->
    uint8 (B, resolution, resolution, 3); it runs in the prefetch thread."""
    import cv2

    def aug(imgs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = np.empty((len(imgs), resolution, resolution, 3), np.uint8)
        for i, im in enumerate(imgs):
            h, w = im.shape[:2]
            if random_rotate:
                deg = rng.uniform(-rotate_degrees, rotate_degrees)
                m = cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0)
                im = cv2.warpAffine(im, m, (w, h), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
            if random_crop:
                zoom = rng.uniform(1.0, max(crop_zoom, 1.0))
                ratio = np.exp(rng.uniform(-crop_ratio, crop_ratio))
                ch = min(int(round(h / zoom * np.sqrt(ratio))), h)
                cw = min(int(round(w / zoom / np.sqrt(ratio))), w)
                y0 = rng.integers(0, h - ch + 1)
                x0 = rng.integers(0, w - cw + 1)
                im = im[y0 : y0 + ch, x0 : x0 + cw]
            if im.shape[:2] != (resolution, resolution):
                im = cv2.resize(im, (resolution, resolution), interpolation=cv2.INTER_AREA)
            if hflip and rng.random() < 0.5:
                im = im[:, ::-1]
            if vflip and rng.random() < 0.5:
                im = im[::-1]
            out[i] = im
        return out

    return aug


class ImageDataset:
    """Epoch iterator over the cached array: each epoch a permutation from the numpy Generator (seeded
    with `seed`), each batch's images read in sorted index order, augmented on the host, scaled to
    [-1, 1] and delivered as NCHW f32 on `device` (cuda unless told otherwise). With prefetch > 0 a
    background thread decodes and stages the next `prefetch` batches (a bounded queue), copying
    through pinned host memory on a card; it stops when the consumer stops. With `mesh` the batches
    are placed for its `data` axis (`parallel.mesh.shard_batch`: on the mesh's one device, which is
    then the device)."""

    def __init__(self, cache_file: str, batch_size: int, seed: int = 0, mesh=None, prefetch: int = 2,
                 data_augment=None, device=None):
        self.data = np.load(cache_file, mmap_mode="r")
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.mesh = mesh
        self.prefetch = prefetch
        self.data_augment = data_augment  # see make_data_augment
        self.device = mesh.single_device("a data-parallel batch") if mesh is not None else resolve_device(device)

    def __len__(self):
        return len(self.data) // self.batch_size

    def _load_batch(self, order, i) -> torch.Tensor:
        idx = order[i * self.batch_size : (i + 1) * self.batch_size]
        imgs = np.asarray(self.data[np.sort(idx)])
        if self.data_augment is not None:
            imgs = self.data_augment(imgs, self.rng)
        batch = torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()
        if self.device.type == "cuda":
            batch = batch.pin_memory().to(self.device, non_blocking=True)
        else:
            batch = batch.to(self.device)
        if self.mesh is not None:
            from ..parallel.mesh import shard_batch

            batch = shard_batch(self.mesh, batch)
        return batch

    def __iter__(self) -> Iterator[torch.Tensor]:
        order = self.rng.permutation(len(self.data))
        if self.prefetch <= 0:
            for i in range(len(self)):
                yield self._load_batch(order, i)
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for i in range(len(self)):
                    # a put blocked during shutdown may still succeed: check stop before the next decode
                    if stop.is_set() or not put(self._load_batch(order, i)):
                        return
                put(None)
            except BaseException as e:  # surfaced in the consumer
                put(e)

        thread = threading.Thread(target=produce, daemon=True, name="maua-data-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            try:
                while not q.empty():
                    q.get_nowait()
                thread.join(timeout=5)
            except Exception:
                pass


def augment_draws(gen: torch.Generator, b: int, h: int, p_flip: float = 0.5, p_translate: float = 0.2,
                  max_shift: float = 0.125, p_color: float = 0.1) -> Dict[str, torch.Tensor]:
    """augment_batch's draws for a batch of b images of height h, from `gen`: flip, do_t, shift
    (b, 2) integers in [-max_shift h, max_shift h], do_c and bright (b,) in [-0.2, 0.2)."""
    d = gen.device
    m = int(max_shift * h)
    return {"flip": torch.rand(b, generator=gen, device=d) < p_flip,
            "do_t": torch.rand(b, generator=gen, device=d) < p_translate,
            "shift": torch.randint(-m, m + 1, (b, 2), generator=gen, device=d),
            "do_c": torch.rand(b, generator=gen, device=d) < p_color,
            "bright": torch.rand(b, generator=gen, device=d) * 0.4 - 0.2}


def augment_batch(gen: Optional[torch.Generator], batch: torch.Tensor, p_flip: float = 0.5,
                  p_translate: float = 0.2, max_shift: float = 0.125, p_color: float = 0.1,
                  draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """ADA-style augmentation of an NCHW batch on its device: x-flip, integer translation (a roll) and
    brightness with a clip to [-1, 1], each per image with its probability; the draws come from `gen`
    (augment_draws) unless given."""
    b, _, h, _ = batch.shape
    if draws is None:
        draws = augment_draws(gen, b, h, p_flip, p_translate, max_shift, p_color)
    dv = batch.device
    flip, do_t, do_c = (torch.as_tensor(draws[k], device=dv).bool() for k in ("flip", "do_t", "do_c"))
    batch = torch.where(flip[:, None, None, None], batch.flip(3), batch)
    shift = torch.where(do_t[:, None], torch.as_tensor(draws["shift"], device=dv).long(), 0).tolist()
    batch = torch.stack([torch.roll(img, (s0, s1), dims=(1, 2)) for img, (s0, s1) in zip(batch, shift)])
    bright = torch.as_tensor(draws["bright"], device=dv, dtype=batch.dtype)[:, None, None, None]
    return torch.where(do_c[:, None, None, None], (batch + bright).clamp(-1, 1), batch)

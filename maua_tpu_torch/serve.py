"""Warm-model inference serving: micro-batched, fixed-shape, HTTP.

Port of `maua_tpu/serve.py`. `MicroBatcher` turns single requests into
device batches: a worker thread takes requests off the queue up to
`max_batch` (waiting at most `max_wait_ms` after the first), pads the
tail by repeating the last row so the batch function always sees one
shape, makes one device call and hands each request its row. A batch of
8 StyleGAN2 frames takes little more card time than one, so batching is
where the throughput is; the tail latency is bounded by max_wait plus a
device step.

Services turn request JSON into fixed-shape arrays and PNGs:

- `GANImageService`     {"seed"|"z", "truncation"} -> StyleGAN2/3 frame
- `ArtifactGANService`  the same, from a `torch.export` artifact
                        (`export.export_generator(truncation=None)`)
- `DiffusionImageService` {"text", "seed", "cfg_scale"} -> SD image
- `UpscaleService`      {"image": base64 png/jpeg} -> upscaled image
                        (max_batch 1: request sizes vary)

HTTP front end (stdlib ThreadingHTTPServer):

    POST /v1/<service>   JSON body -> image/png
    GET  /healthz        JSON metrics (served, p50/p95 ms, occupancy)

CLI: ``python -m maua_tpu_torch serve http --model_file G.pkl --port 8080``
(on the card unless ``--device cpu``).

The batch functions run on the batcher's worker thread, where PyTorch's
grad mode is its own (grad mode is thread-local): each enters
`torch.inference_mode()` itself, so no autograd graph is recorded and the
kernels are launched bare. Kernels build at their first launch, which
happens on that thread: `--warmup` runs one batch before traffic arrives.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .utility import resolve_device

# ------------------------------------------------------------- metrics


class ServiceMetrics:
    """Thread-safe serving counters and latency percentiles."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.served = 0
        self.errors = 0
        self.batches = 0
        self.occupancy_sum = 0
        self.max_occupancy = 0
        self._latencies_ms: deque = deque(maxlen=window)

    def record_batch(self, occupancy: int) -> None:
        with self._lock:
            self.batches += 1
            self.occupancy_sum += occupancy
            self.max_occupancy = max(self.max_occupancy, occupancy)

    def record_request(self, latency_s: float, error: bool = False) -> None:
        with self._lock:
            if error:
                self.errors += 1
            else:
                self.served += 1
                self._latencies_ms.append(latency_s * 1e3)

    def snapshot(self) -> Dict:
        with self._lock:
            lats = np.asarray(self._latencies_ms, np.float64)
            return {
                "served": self.served,
                "errors": self.errors,
                "batches": self.batches,
                "mean_occupancy": round(self.occupancy_sum / max(self.batches, 1), 3),
                "max_occupancy": self.max_occupancy,
                "p50_ms": round(float(np.percentile(lats, 50)), 2) if lats.size else None,
                "p95_ms": round(float(np.percentile(lats, 95)), 2) if lats.size else None,
            }


# --------------------------------------------------------- micro-batch


class MicroBatcher:
    """Coalesce single requests into fixed-shape device batches.

    ``run_batch`` receives a dict of arrays stacked on axis 0 and padded to
    exactly ``max_batch`` rows and returns an array (or a dict of arrays)
    with the same leading dim; each submitter's Future resolves to its row.
    """

    _CLOSE = object()

    def __init__(
        self,
        run_batch: Callable[[Dict[str, np.ndarray]], np.ndarray],
        max_batch: int = 8,
        max_wait_ms: float = 15.0,
        metrics: Optional[ServiceMetrics] = None,
    ):
        assert max_batch >= 1
        self._run = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.metrics = metrics or ServiceMetrics()
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True, name="maua-microbatch")
        self._closed = False
        self._thread.start()

    def submit(self, request: Dict[str, np.ndarray]) -> Future:
        """request: dict of arrays, each with leading dim 1."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((request, fut, time.perf_counter()))
        return fut

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(self._CLOSE)
            self._thread.join()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is self._CLOSE:
                return
            batch = [item]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is self._CLOSE:
                    self._execute(batch)
                    return
                batch.append(nxt)
            self._execute(batch)

    def _execute(self, batch) -> None:
        requests = [b[0] for b in batch]
        n = len(requests)
        self.metrics.record_batch(n)
        try:
            stacked = {k: np.concatenate([np.asarray(r[k]) for r in requests], axis=0) for k in requests[0]}
            pad = self.max_batch - n
            if pad:
                stacked = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0) for k, v in stacked.items()}
            out = self._run(stacked)
            if isinstance(out, dict):
                rows = [{k: np.asarray(v)[i] for k, v in out.items()} for i in range(n)]
            else:
                out = np.asarray(out)
                rows = [out[i] for i in range(n)]
        except Exception as e:
            for _, fut, t0 in batch:
                self.metrics.record_request(time.perf_counter() - t0, error=True)
                fut.set_exception(e)
            return
        for (_, fut, t0), row in zip(batch, rows):
            self.metrics.record_request(time.perf_counter() - t0)
            fut.set_result(row)


# ------------------------------------------------------------ services


def _encode_png(img_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(img_u8)).save(buf, format="PNG")
    return buf.getvalue()


def _find_w_avg(params):
    """The mapping network's running w average in a parameter tree, or None."""
    if isinstance(params, dict):
        if "w_avg" in params:
            return params["w_avg"]
        for v in params.values():
            found = _find_w_avg(v)
            if found is not None:
                return found
    return None


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """NCHW [-1, 1] -> NHWC uint8 as maua_tpu casts it: clipped, then truncated."""
    return torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def _seeded_z(payload: Dict, z_dim: int) -> np.ndarray:
    """The request's z (1, z_dim): given, or numpy's RandomState(seed) draw (maua_tpu's, so both packages
    serve the same z for a seed)."""
    if "z" in payload:
        return np.asarray(payload["z"], np.float32).reshape(1, z_dim)
    return np.random.RandomState(int(payload.get("seed", 0))).randn(1, z_dim).astype(np.float32)


class _Service:
    """The request plumbing the services share: a batcher over `_run`, its metrics, PNG rendering."""

    def _start(self, max_batch: int, max_wait_ms: float) -> None:
        self.metrics = ServiceMetrics()
        self._batcher = MicroBatcher(self._run, max_batch=max_batch, max_wait_ms=max_wait_ms, metrics=self.metrics)

    def submit(self, payload: Dict) -> Future:
        return self._batcher.submit(self.request_from_json(payload))

    def render_png(self, payload: Dict, timeout: float = 300.0) -> bytes:
        return _encode_png(self.submit(payload).result(timeout=timeout))

    def close(self) -> None:
        self._batcher.close()


class GANImageService(_Service):
    """seed/z (+ per-request truncation) -> uint8 RGB frame (H, W, 3).

    One warm generator, one batch shape. Per-request truncation is the
    mapper's `w_avg + psi * (w - w_avg)` lerp, applied over the batch so
    requests with different psi share one device call."""

    name = "gan"

    def __init__(
        self,
        generator=None,
        model_file: Optional[str] = None,
        architecture: str = "stylegan2",
        max_batch: int = 8,
        max_wait_ms: float = 15.0,
        mesh=None,
        device=None,
    ):
        if generator is None:
            from .gan.wrappers import get_generator_class

            generator = get_generator_class(architecture)(model_file=model_file, device=resolve_device(device))
        self.gen = generator
        self._w_avg = _find_w_avg(self.gen.params)
        # the request batch on the mesh's `data` axis (one device: see parallel/mesh.py)
        self.mesh = mesh
        if mesh is not None:
            n_data = mesh.shape["data"]
            if max_batch % n_data:
                max_batch = max(max_batch // n_data, 1) * n_data
        self._start(max_batch, max_wait_ms)

    def _shard(self, x):
        if self.mesh is None:
            return x
        from .parallel.mesh import shard_batch

        return shard_batch(self.mesh, x)

    def _run(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        with torch.inference_mode():
            dev = self.gen.device
            ws = self.gen.mapper(self._shard(torch.as_tensor(batch["z"], dtype=torch.float32, device=dev)))
            if self._w_avg is not None:
                psi = torch.as_tensor(batch["truncation"], dtype=torch.float32, device=dev)[:, None, None]
                ws = self._w_avg + psi * (ws - self._w_avg)
            return to_u8(self.gen.synthesizer(ws)).cpu().numpy()

    def request_from_json(self, payload: Dict) -> Dict[str, np.ndarray]:
        psi = np.asarray([float(payload.get("truncation", 1.0))], np.float32)
        return {"z": _seeded_z(payload, self.gen.z_dim), "truncation": psi}

    def warmup(self, timeout: float = 1200.0) -> None:
        """One batch before traffic: the kernels build and the s2d plan is probed at their first use."""
        self.submit({"seed": 0}).result(timeout=timeout)


class ArtifactGANService(_Service):
    """Frames from a `torch.export` artifact (`export.export_generator` with truncation=None): the
    serving process imports no model module, only `maua_tpu_torch.export` and the kernels' ops.

    The artifact fixes the batch shape, so the batcher's max_batch is read from its signature."""

    name = "gan"

    def __init__(self, artifact: str, max_wait_ms: float = 15.0):
        import re

        from .export import exported_meta, load_exported

        self._call = load_exported(artifact)
        meta = exported_meta(artifact)
        if len(meta["in_avals"]) != 2:
            raise ValueError(f"artifact {artifact!r} must have the (z, psi) signature "
                             f"(export_generator(truncation=None)); got {meta['in_avals']}")
        m = re.search(r"\[(\d+),(\d+)\]", meta["in_avals"][0].replace(" ", ""))
        if m is None:
            raise ValueError(f"cannot parse z shape from {meta['in_avals'][0]!r}")
        batch, self.z_dim = int(m.group(1)), int(m.group(2))
        self._start(batch, max_wait_ms)

    def _run(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        with torch.inference_mode():
            return self._call(batch["z"].astype(np.float32), batch["truncation"].astype(np.float32)).cpu().numpy()

    def request_from_json(self, payload: Dict) -> Dict[str, np.ndarray]:
        psi = np.asarray([float(payload.get("truncation", 1.0))], np.float32)
        return {"z": _seeded_z(payload, self.z_dim), "truncation": psi}

    def warmup(self, timeout: float = 1200.0) -> None:
        self.submit({"seed": 0}).result(timeout=timeout)


def seeded_noise(p, seeds, device) -> torch.Tensor:
    """Each request's standard-normal latent (B, z, h, w), from its own torch.Generator seeded with its
    seed on `device`: an image is fixed by (text, seed) whatever shares its batch."""
    ds = p.vae_cfg.downscale
    shape = (p.vae_cfg.z_channels, p.image_size // ds, p.image_size // ds)
    return torch.stack([torch.randn(shape, generator=torch.Generator(device=device).manual_seed(int(s)),
                                    device=device) for s in np.asarray(seeds).reshape(-1)])


def text2img_fn(p) -> Callable:
    """The batched text -> image function of an SD-class processor: `(tokens (B, L), seeds (B,), scales
    (B,), noise=None) -> uint8 frames (B, H, W, 3)`. The noise is each request's draw (`seeded_noise`)
    unless given, (B, h, w, z) NHWC as maua_tpu draws it; per-request cfg scales broadcast as (B, 1, 1, 1)
    through `cfg_denoiser`. Ancestral samplers draw their in-loop noise from a generator seeded with the
    batch's first seed (maua_tpu's key of it), so their images depend on the batch."""
    from .diffusion.samplers import ANCESTRAL, get_sampler
    from .diffusion.wrappers import cfg_denoiser
    from .text.clip_text import encode_text, tokenize

    sigmas = np.asarray(p.get_sigmas(0.0, 1.0))
    with torch.no_grad():  # the empty prompt's conditioning, the same for every batch
        uncond = encode_text(p.text_params, tokenize("", p.text_cfg.context_length), p.text_cfg)
    sample_fn = get_sampler(p.sampler_name)
    ancestral = p.sampler_name in ANCESTRAL

    def run(tokens, seeds, scales, noise=None):
        dev = p.device
        cond = encode_text(p.text_params, tokens, p.text_cfg)
        scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None, None, None]
        model_fn = cfg_denoiser(p.denoiser, cond, uncond, scales)
        if noise is None:
            eps = seeded_noise(p, seeds, dev)
        else:
            eps = torch.as_tensor(noise, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
        x = eps * float(sigmas[0])
        if ancestral:
            seed0 = int(np.asarray(seeds).reshape(-1)[0])
            out = sample_fn(model_fn, x, sigmas, gen=torch.Generator(device=dev).manual_seed(seed0))
        else:
            out = sample_fn(model_fn, x, sigmas)
        return to_u8(p.decode(out))

    return run


class DiffusionImageService(_Service):
    """text (+ seed, cfg_scale) -> image through a warm SD-class processor.

    Different prompts batch into one CFG denoise loop: texts tokenize to the
    model's context length at request time, the conditions encode as a
    batch, and each request's cfg_scale rides as a (B, 1, 1, 1) broadcast.
    Each request's seed draws its own initial noise, so an image is fixed
    by (text, seed) whatever shares its batch, except with ancestral
    samplers. Serving runs the whole unguided schedule."""

    name = "diffusion"

    def __init__(self, processor=None, max_batch: int = 4, max_wait_ms: float = 100.0, device=None,
                 **processor_kwargs):
        if processor is None:
            from .diffusion.image import get_diffusion_model

            processor = get_diffusion_model("stable", device=resolve_device(device), **processor_kwargs)
        self.proc = processor
        self._fn = text2img_fn(self.proc)
        self._start(max_batch, max_wait_ms)

    def _run(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        with torch.inference_mode():
            return self._fn(batch["tokens"], batch["seed"], batch["cfg_scale"]).cpu().numpy()

    def request_from_json(self, payload: Dict) -> Dict[str, np.ndarray]:
        from .text.clip_text import tokenize

        tokens = tokenize(str(payload.get("text", "")), self.proc.text_cfg.context_length)
        seed = np.asarray([int(payload.get("seed", 0))], np.int64)
        scale = np.asarray([float(payload.get("cfg_scale", self.proc.cfg_scale))], np.float32)
        return {"tokens": tokens, "seed": seed, "cfg_scale": scale}

    def render_png(self, payload: Dict, timeout: float = 600.0) -> bytes:
        return super().render_png(payload, timeout)

    def warmup(self, timeout: float = 1200.0) -> None:
        self.submit({"text": "", "seed": 0}).result(timeout=timeout)


class UpscaleService(_Service):
    """base64 image -> upscaled image through a warm `super` model (max_batch 1: request sizes vary;
    the batcher still serializes the device)."""

    name = "upscale"

    def __init__(self, model_name: str = "RealESRGAN-x4plus", tile: int = 0, max_wait_ms: float = 0.0, device=None,
                 upscaler=None):
        from .super.image import Upscaler

        self.upscaler = upscaler or Upscaler(model_name, tile=tile, device=resolve_device(device))
        self._start(1, max_wait_ms)

    def _run(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        with torch.inference_mode():
            out = self.upscaler(batch["image"].astype(np.float32) / 255.0).cpu().numpy()
        return (np.clip(out, 0, 1) * 255.0).astype(np.uint8)

    def request_from_json(self, payload: Dict) -> Dict[str, np.ndarray]:
        from PIL import Image

        raw = base64.b64decode(payload["image"])
        return {"image": np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.uint8)[None]}


# ----------------------------------------------------------------- http


def make_http_server(services: Dict[str, object], host: str = "127.0.0.1", port: int = 8080):
    """ThreadingHTTPServer over the given {route-name: service} map."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, obj: Dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/metrics"):
                self._json(200, {name: svc.metrics.snapshot() for name, svc in services.items()})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            parts = [p for p in self.path.split("/") if p]
            name = parts[-1] if parts else ""
            svc = services.get(name)
            if svc is None:
                self._json(404, {"error": f"unknown service {name!r}", "services": sorted(services)})
                return
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
                payload = json.loads(self.rfile.read(length) or b"{}")
                png = svc.render_png(payload)
            except Exception as e:
                self._json(400, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    return ThreadingHTTPServer((host, port), Handler)


def build_services(args) -> Dict[str, object]:
    """The services `main`'s arguments ask for, each warmed up with --warmup."""
    services: Dict[str, object] = {}
    if args.artifact:
        services[ArtifactGANService.name] = ArtifactGANService(args.artifact, max_wait_ms=args.max_wait_ms)
    else:
        services[GANImageService.name] = GANImageService(
            model_file=args.model_file, architecture=args.architecture, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, device=args.device)
    if args.upscale_model:
        services[UpscaleService.name] = UpscaleService(args.upscale_model, device=args.device)
    if args.diffusion:
        services[DiffusionImageService.name] = DiffusionImageService(timesteps=args.timesteps, sampler=args.sampler,
                                                                     device=args.device)
    if args.warmup:
        for name, svc in services.items():
            warm = getattr(svc, "warmup", None)
            if warm is not None:
                warm()
                print(f"warmup done: {name}")
    return services


def main(args=None):
    import argparse

    # fmt: off
    parser = argparse.ArgumentParser(description="warm-model inference server (micro-batched)")
    parser.add_argument("--model_file", default=None, type=str, help="GAN checkpoint (random init if omitted)")
    parser.add_argument("--artifact", default=None, type=str, help="serve /v1/gan from a torch.export artifact instead of a checkpoint")
    parser.add_argument("--architecture", default="stylegan2", choices=["stylegan2", "stylegan3"])
    parser.add_argument("--upscale_model", default=None, type=str, help="also serve /v1/upscale with this super model")
    parser.add_argument("--diffusion", action="store_true", help="also serve /v1/diffusion (SD-class text-to-image)")
    parser.add_argument("--timesteps", default=20, type=int, help="diffusion steps for /v1/diffusion")
    parser.add_argument("--sampler", default="euler", type=str, help="sampler for /v1/diffusion")
    parser.add_argument("--host", default="127.0.0.1", type=str)
    parser.add_argument("--port", default=8080, type=int)
    parser.add_argument("--max_batch", default=8, type=int)
    parser.add_argument("--max_wait_ms", default=15.0, type=float)
    parser.add_argument("--warmup", action="store_true", help="run one batch (building the kernels) before accepting traffic")
    parser.add_argument("--device", default="cuda", type=str, help='default "cuda"; "cpu" runs the plain versions')
    args = parser.parse_args(args)
    # fmt: on

    services = build_services(args)
    server = make_http_server(services, host=args.host, port=args.port)
    print(f"serving {sorted(services)} on http://{args.host}:{server.server_address[1]} "
          f"(POST /v1/<service>, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        for svc in services.values():
            svc.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

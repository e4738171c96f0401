"""Model export: `torch.export` artifacts for deployment.

Port of `maua_tpu/export.py`, with `torch.export` in the place of
StableHLO. A deployment may want a model that loads without the Python
model code: a serving fleet that ships the runtime and one file. A
function traced by non-strict `torch.export` becomes an ExportedProgram
whose graph holds the weights it closes over as constants; the epilogue,
flash-attention and filtered-lrelu kernels are `torch.library` custom ops
(`maua_tpu_torch/kernels`), so the graph calls them and, on the card,
each call launches the hand-written kernel.

    from maua_tpu_torch.export import export_generator, load_exported
    export_generator(StyleGAN2(model_file="G.pkl"), "g.pt2", batch_size=8)
    ...
    synth = load_exported("g.pt2")   # imports no model module
    frames = synth(z, psi)           # (8, H, W, 3) uint8

The artifact is the saved program (torch.export's zip archive) with
`meta.json` among its extra files: the signature in maua_tpu's form
(`in_avals` such as "float32[8,512]"), which `exported_meta` reads without
loading the program. The program runs on the device it was exported on.
Loading it needs only this module and the kernels' op registrations.
"""

from __future__ import annotations

import json
import zipfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

_META_NAME = "meta.json"


def aval(t: torch.Tensor) -> str:
    """A tensor's signature as maua_tpu writes it: dtype[d0,d1,...]."""
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(str(int(d)) for d in t.shape)}]"


class _Traced(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def trace(fn: Callable, example_args: Tuple) -> torch.export.ExportedProgram:
    """`fn(*example_args)` traced by non-strict torch.export (under no_grad): the tensors `fn` closes over
    (weights) become the program's constants, and the kernels' custom ops stay calls in its graph."""
    with torch.no_grad():
        return torch.export.export(_Traced(fn), tuple(example_args), strict=False)


def save_program(program: torch.export.ExportedProgram, example_args: Tuple, path: str) -> str:
    """Write a traced program and its signature (`meta.json`) as one artifact."""
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out_node.args[0] if hasattr(a, "meta") and "val" in a.meta]
    device = example_args[0].device
    meta = {
        "in_avals": [aval(a) for a in example_args],
        "out_avals": [aval(o) for o in outs],
        "platforms": [device.type],
        "device": str(device),
        "torch": torch.__version__,
    }
    torch.export.save(program, path, extra_files={_META_NAME: json.dumps(meta, indent=1)})
    return path


def export_fn(fn: Callable, example_args: Tuple, path: str) -> str:
    """Trace `fn(*example_args)` and write the artifact: it replays the traced computation for inputs of
    the example shapes and dtypes, on their device, with the weights baked in."""
    return save_program(trace(fn, example_args), example_args, path)


def exported_meta(path: str) -> dict:
    """An artifact's signature, without loading the program."""
    with zipfile.ZipFile(path) as zf:
        name = next(n for n in zf.namelist() if n.endswith(f"/extra/{_META_NAME}"))
        return json.loads(zf.read(name))


def register_kernel_ops() -> None:
    """Import the kernel modules whose custom ops an exported graph may call."""
    from .kernels import attention, epilogue, filtered_lrelu  # noqa: F401


def load_exported(path: str) -> Callable:
    """An artifact as a callable: numpy arrays or tensors in (moved to the program's device), the
    program's output tensor out. Needs no model module."""
    register_kernel_ops()
    device = torch.device(exported_meta(path)["device"])
    module = torch.export.load(path).module()

    def call(*args):
        return module(*(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a, device=device)
                        for a in args))

    return call


def diffusion_program(processor, batch_size: int = 2) -> Tuple[Callable, Tuple]:
    """`export_diffusion`'s function and example inputs (see there)."""
    from .diffusion.samplers import ANCESTRAL
    from .serve import text2img_fn

    if processor.sampler_name in ANCESTRAL:
        raise ValueError(f"the {processor.sampler_name} sampler draws noise inside its loop; an exported program "
                         f"takes its noise as an input: use a sampler without ancestral steps")
    run = text2img_fn(processor)
    dev = processor.device
    ds = processor.vae_cfg.downscale
    tokens = torch.zeros((batch_size, processor.text_cfg.context_length), dtype=torch.int64, device=dev)
    noise = torch.zeros((batch_size, processor.image_size // ds, processor.image_size // ds,
                         processor.vae_cfg.z_channels), device=dev)
    scales = torch.ones((batch_size,), device=dev)
    return (lambda t, n, s: run(t, None, s, noise=n)), (tokens, noise, scales)


def export_diffusion(processor, path: str, batch_size: int = 2) -> str:
    """Export an SD-class processor's whole text -> image sampler: `(tokens (B, L) int64, noise (B, h, w,
    z) f32, cfg_scales (B,) f32) -> uint8 frames (B, H, W, 3)`. Text encoder, the CFG denoise loop, the
    VAE decode and all weights go into one program; tokenization stays on the host
    (`text.clip_text.tokenize`). maua_tpu's program takes seeds and draws inside; a torch.Generator is
    not a graph input, so the noise is drawn outside (`serve.seeded_noise(processor, seeds, device)`
    draws each seed's as the service does) and ancestral samplers, which draw inside the loop, are
    refused."""
    return export_fn(*diffusion_program(processor, batch_size), path)


def export_generator(gen, path: str, batch_size: int = 1, truncation: Optional[float] = None) -> str:
    """Export a GAN facade (StyleGAN2/3) as a frames program at a fixed batch size (the serving
    contract: one shape). truncation=None exports `(z, psi) -> uint8 frames` with per-sample truncation
    as an input, what `serve.ArtifactGANService` takes; a float bakes it in: `z -> uint8 frames`."""
    from .serve import _find_w_avg, to_u8

    z = torch.zeros((batch_size, gen.z_dim), device=gen.device)
    prime = getattr(gen, "_get_fast", None)
    if prime is not None:
        prime()  # the s2d plan is probed on real tensors, before the trace
    if truncation is not None:
        return export_fn(lambda z: to_u8(gen.synthesizer(gen.mapper(z, truncation=truncation))), (z,), path)
    w_avg = _find_w_avg(gen.params)

    def synth(z, psi):
        ws = gen.mapper(z)
        if w_avg is not None:
            ws = w_avg + psi[:, None, None] * (ws - w_avg)
        return to_u8(gen.synthesizer(ws))

    return export_fn(synth, (z, torch.ones((batch_size,), device=gen.device)), path)

"""`python -m maua_tpu_torch <command> <subcommand> [options]`: audiovisual
generate, audiovisual interactive, audiovisual selfsupervised, autoregressive
generate, autoregressive video, diffusion image, diffusion video, diffusion
interpolate, diffusion klmc2, diffusion outpaint, diffusion loop, gan generate,
gan train, nca run, style image, style video, super image, super video.

As in maua_tpu, `autoregressive finetune | api | min | rq ...` reach the
autoregressive generate command's own subcommands."""

import importlib
import sys

COMMANDS = {
    ("audiovisual", "generate"): "maua_tpu_torch.audiovisual.generate",
    ("audiovisual", "interactive"): "maua_tpu_torch.audiovisual.interactive",
    ("audiovisual", "selfsupervised"): "maua_tpu_torch.audiovisual.selfsupervised.sample",
    ("autoregressive", "generate"): "maua_tpu_torch.autoregressive.cli",
    ("autoregressive", "video"): "maua_tpu_torch.autoregressive.video_cli",
    ("diffusion", "image"): "maua_tpu_torch.diffusion.image",
    ("diffusion", "video"): "maua_tpu_torch.diffusion.video",
    ("diffusion", "interpolate"): "maua_tpu_torch.diffusion.interpolate",
    ("diffusion", "klmc2"): "maua_tpu_torch.diffusion.klmc2",
    ("diffusion", "outpaint"): "maua_tpu_torch.diffusion.outpaint",
    ("diffusion", "loop"): "maua_tpu_torch.diffusion.loop_direct",
    ("gan", "generate"): "maua_tpu_torch.gan.cli",
    ("gan", "train"): "maua_tpu_torch.gan.train_cli",
    ("nca", "run"): "maua_tpu_torch.nca.nca",
    ("style", "image"): "maua_tpu_torch.style.cli",
    ("style", "video"): "maua_tpu_torch.style.video",
    ("super", "image"): "maua_tpu_torch.super.image",
    ("super", "video"): "maua_tpu_torch.super.video",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["autoregressive"] and argv[1:2] in (["finetune"], ["api"], ["min"], ["rq"]):
        argv = ["autoregressive", "generate"] + argv[1:]
    module = COMMANDS.get(tuple(argv[:2]))
    if module is None:
        sys.exit("usage: python -m maua_tpu_torch {" + " | ".join(" ".join(c) for c in COMMANDS) + "} [options]")
    return importlib.import_module(module).main(argv[2:])


if __name__ == "__main__":
    main()

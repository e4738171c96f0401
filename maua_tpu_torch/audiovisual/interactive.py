"""The interactive, segmentation-driven patch evolution REPL.

Port of `maua_tpu/audiovisual/interactive.py`: the audio is cut into
sections (laplacian segmentation at a granularity, or manual
{seconds: label} bounds); each unique label gets a seeded `Patch` and a
latent palette, evolved by commands with an undo stack; the final render
walks the whole timeline, each bound through its label's patch, with
EMA crossfades of latents and noise at the bounds, on `device` (cuda
unless told otherwise).

Unlike maua_tpu, the render covers every frame of the timeline: a bound
longer than its label's patch (which has the length of the label's
first section) continues that patch, its latents and noise windows
wrapped modulo the patch's length, and its fades count the bound's own
frames. maua_tpu cuts such a bound to the patch's length, so its video
comes out shorter than the audio.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..audio.io import load_audio
from ..gan.wrappers import StyleGAN2, layer_names
from ..ops.video import VideoWriter, ffmpeg_available, pipelined_frames
from ..utility import StageClock, resolve_device
from .selfsupervised import patch as P
from .selfsupervised.mir import retrieve_music_information

HELP = """\
'help' to show this message
'next' to continue to the next section (or final render)
'quit' to exit
(1) more_intense
(2) less_intense
(3) different_style
(4) similar_style
(5) different_style_motion
(6) similar_style_motion
(7) different_structure_motion
(8) similar_structure_motion
(9) revert"""


class EMAFade:
    """Frame-indexed EMA crossfade at section bounds: the last `fade_frames`
    of a section ramp into a carried average, which the next section's
    first `fade_frames` ramp back out of. Works on the window's device; the
    schedule is a host array, so nothing waits for the device."""

    def __init__(self, fade_frames: int):
        self.fade_frames = int(fade_frames)
        self.smooth_schedule = np.concatenate(
            [np.linspace(1, 0, self.fade_frames), np.linspace(0, 1, self.fade_frames)]
        )
        self.avg: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor, i: int, total_length: int) -> torch.Tensor:
        batch_size = x.shape[0]
        fade_start = total_length - self.fade_frames
        if not (i < self.fade_frames or i + batch_size >= fade_start):
            return x
        x = x.clone()
        for batch_idx, frame_idx in enumerate(range(i, i + batch_size)):
            if frame_idx == fade_start:
                self.avg = x[batch_idx].clone()
            if self.fade_frames < frame_idx < fade_start or self.avg is None:
                continue
            smooth_idx = frame_idx - fade_start if frame_idx - fade_start >= 0 else self.fade_frames + frame_idx
            s = float(self.smooth_schedule[min(smooth_idx, len(self.smooth_schedule) - 1)])
            self.avg = self.avg * (1 - s) + x[batch_idx] * s
            x[batch_idx] = self.avg
        return x


def segment_audio(audio, sr: int, fps: float, spec: Union[int, Dict[float, int]],
                  segmentations: Optional[Dict] = None) -> np.ndarray:
    """Per-frame section labels: an int picks the laplacian segmentation
    nearest that granularity; {seconds: label} sets the bounds by hand."""
    duration = len(audio) / sr
    n_frames = round(duration * fps)
    if isinstance(spec, dict):
        times = list(spec.keys())
        labels = list(spec.values())
        out = []
        for start, end, label in zip(times, times[1:] + [duration], labels):
            out.append(np.full(round(end * fps) - round(start * fps), label))
        return np.concatenate(out)[:n_frames]
    if segmentations is None:
        _, segmentations, _ = retrieve_music_information(torch.as_tensor(audio), sr)
    ks = sorted(set(k for (_, k) in segmentations.keys()))
    k = min(ks, key=lambda kk: abs(kk - spec))
    key = next(key for key in segmentations if key[1] == k)
    labels = np.asarray(segmentations[key])
    idx = np.clip((np.arange(n_frames) * len(labels)) // max(n_frames, 1), 0, len(labels) - 1)
    return labels[idx]


def sections_from_labels(labels: np.ndarray, fps: float
                         ) -> Tuple[List[Tuple[int, float, float]], List[int], List[float]]:
    """Unique labels -> one representative (label, start_s, end_s) section
    each (its first), plus the whole timeline (bound labels, bound times)."""
    labels = np.asarray(labels)
    bounds = [0] + list(1 + np.flatnonzero(labels[:-1] != labels[1:])) + [len(labels)]
    bound_labels = [int(labels[b]) for b in bounds[:-1]]
    bound_times = [b / fps for b in bounds]
    sections = []
    for lbl in sorted(set(bound_labels)):
        first = bound_labels.index(lbl)
        sections.append((lbl, bound_times[first], bound_times[first + 1]))
    return sections, bound_labels, bound_times


class InteractiveSession:
    """Command-driven per-section patch evolution on `device` (cuda unless
    told otherwise). `palette_fn(seed)` gives a section's (N, L, D) latent
    palette; by default seeded normal draws on the device."""

    COMMAND_ALIASES = {
        "1": "more_intense", "2": "less_intense", "3": "different_style", "4": "similar_style",
        "5": "different_style_motion", "6": "similar_style_motion",
        "7": "different_structure_motion", "8": "similar_structure_motion", "9": "revert",
        "more": "more_intense", "less": "less_intense", "style": "different_style_motion",
        "motion": "different_structure_motion",
    }

    def __init__(
        self,
        audio,
        sr: int,
        fps: float = 24,
        seed: int = 0,
        segmentation: Union[int, Dict[float, int]] = 5,
        palette_fn: Optional[Callable[[int], torch.Tensor]] = None,
        palette_size: int = 20,
        latent_dim: int = 512,
        latent_layers: int = 8,
        device=None,
    ):
        self.fps = fps
        self.seed = seed
        self.device = resolve_device(device)
        audio = torch.as_tensor(audio, device=self.device)
        features, segmentations, self.tempo = retrieve_music_information(audio, sr)
        # re-index the MIR's hop frames to video frames, so sections, patches
        # and the render share one clock
        n_frames = max(round(len(audio) / sr * fps), 1)

        def frame_idx(n):
            return np.clip((np.arange(n_frames) * n) // n_frames, 0, n - 1)

        self.features = {k: f[torch.as_tensor(frame_idx(len(f)), device=f.device)] for k, f in features.items()}
        self.segmentations = {k: np.asarray(s)[frame_idx(len(s))] for k, s in segmentations.items()}
        self.labels = segment_audio(audio, sr, fps, segmentation, self.segmentations)
        self.sections, self.bound_labels, self.bound_times = sections_from_labels(self.labels, fps)
        if palette_fn is None:
            palette_fn = lambda s: P.seeded_normal(s, (palette_size, latent_layers, latent_dim), self.device)
        self.palette_fn = palette_fn

        self.patches: Dict[int, P.Patch] = {}
        self.palettes: Dict[int, torch.Tensor] = {}
        self.intensity: Dict[int, float] = {}
        self._history: Dict[int, List] = {}
        self._rng = np.random.default_rng(seed)
        for i, (label, start, end) in enumerate(self.sections):
            sf, ef = round(start * fps), round(end * fps)
            feats = {k: f[sf:ef] for k, f in self.features.items()}
            segs = {k: s[sf:ef] for k, s in self.segmentations.items()}
            self.patches[label] = P.Patch(feats, segs, self.tempo, fps=fps, seed=seed + i)
            self.palettes[label] = palette_fn(seed + i)
            self.intensity[label] = 0.666
            self._history[label] = []

    # ------------------------------------------------------- commands
    def apply(self, command: str, label: int) -> str:
        """One evolution command for one section; every command but revert
        first pushes (patch, palette) on the section's undo stack."""
        command = self.COMMAND_ALIASES.get(command, command)
        if command == "help":
            return HELP
        p = self.patches[label]
        if command != "revert":
            self._history[label].append((copy.deepcopy(p), self.palettes[label]))
        if command == "more_intense":
            self.intensity[label] += 0.111
            p.update_intensity(self.intensity[label])
        elif command == "less_intense":
            self.intensity[label] -= 0.111
            p.update_intensity(self.intensity[label])
        elif command == "different_style":
            self.palettes[label] = self.palette_fn(int(self._rng.integers(2**31)))
        elif command == "similar_style":
            perm = self._rng.permutation(self.palettes[label].shape[0])
            self.palettes[label] = self.palettes[label][torch.as_tensor(perm, device=self.palettes[label].device)]
        elif command == "different_style_motion":
            p.randomize_latent_patches()
        elif command == "similar_style_motion":
            p.latent_patches = list(self._rng.permutation(np.asarray(p.latent_patches, dtype=object)))
        elif command == "different_structure_motion":
            p.randomize_noise_patches()
        elif command == "similar_structure_motion":
            p.noise_patches = list(self._rng.permutation(np.asarray(p.noise_patches, dtype=object)))
        elif command == "revert":
            if not self._history[label]:
                return f"section {label}: nothing to revert"
            self.patches[label], self.palettes[label] = self._history[label].pop()
        elif command == "show":
            return repr(p)
        else:
            return f"unknown command {command!r}\n{HELP}"
        return f"section {label}: {command}"

    # ------------------------------------------------------ realization
    def preview(self, label: int, noise_sizes: Sequence[int] = (4,), preview_frames: Optional[int] = None,
                save_patch: Optional[str] = None):
        """One section's (latents, noise modules); optionally JSON-save its patch."""
        lats, noises = self.patches[label](self.palettes[label], noise_sizes=list(noise_sizes))
        if preview_frames:
            lats = lats[:preview_frames]
        if save_patch:
            self.patches[label].save(save_patch)
        return lats, noises

    def render_final(self, synthesizer: Callable, batch_size: int = 8, fade_time: float = 2.0,
                     noise_sizes: Sequence[int] = (4,)):
        """Walk the whole timeline: each bound realizes its label's patch for
        all of its frames (wrapping the patch where the bound is longer),
        latents and noise crossfaded by EMAFade at the bounds; yields
        `synthesizer(latents, {"noise<j>": window})` per batch."""
        fade_frames = max(int(fade_time * self.fps), 1)
        latent_fade = EMAFade(fade_frames)
        noise_fades: Dict[int, EMAFade] = {}
        for label, start, end in zip(self.bound_labels, self.bound_times[:-1], self.bound_times[1:]):
            lats, noises = self.patches[label](self.palettes[label], noise_sizes=list(noise_sizes))
            total = round((end - start) * self.fps)
            for i in range(0, total, batch_size):
                b = min(batch_size, total - i)
                L = latent_fade(lats[torch.arange(i, i + b, device=lats.device) % lats.shape[0]], i, total)
                N = {}
                for j, noise_mod in enumerate(noises):
                    fade = noise_fades.setdefault(j, EMAFade(fade_frames))
                    N[f"noise{j}"] = fade(noise_mod(i, b), i, total)
                yield synthesizer(L, N)

    # ------------------------------------------------------------ REPL
    def repl(self, input_fn=input, print_fn=print) -> bool:
        """The blocking per-section command loop. True when every section
        was tuned; False on quit or Ctrl-C, so the caller skips the render."""
        print_fn(HELP)
        for label, start, end in self.sections:
            print_fn(f"Section {label}: {start:.1f}s - {end:.1f}s")
            while True:
                try:
                    line = input_fn("> ").strip()
                except (EOFError, KeyboardInterrupt):
                    return False
                if line in ("next", "n", ""):
                    break
                if line in ("quit", "q"):
                    return False
                for command in line.split(","):
                    print_fn(self.apply(command.strip(), label))
        return True


WELCOME = """
Welcome to the audio-reactive video synthesizer!

Your audio is segmented into sections; each section gets its own
audio-reactive patch that you evolve with the commands below. When
every section is tuned, the parts are stitched together with EMA
crossfades and rendered to video.

Quit at any time with CTRL+C or by typing 'quit'.
"""


def generate_interactive(
    audio_file: str,
    model_file: Optional[str] = None,
    output_file: Optional[str] = None,
    fps: float = 24,
    seed: int = 0,
    segmentation: Union[int, Dict[float, int]] = 5,
    batch_size: int = 8,
    out_size: Tuple[int, int] = (512, 512),
    fade_time: float = 2.0,
    palette_size: int = 20,
    stylegan_kwargs: Optional[dict] = None,
    input_fn=input,
    print_fn=print,
    device=None,
    stage_times: Optional[Dict[str, float]] = None,
) -> Optional[str]:
    """Load the audio, segment it, run the per-section command loop, then
    render the crossfaded timeline through the StyleGAN2 facade at
    `out_size` into a video; returns its path, or None on quit.
    `stage_times`, when given, receives the seconds of session (MIR,
    patches, palettes), repl and render (synthesis and writing)."""
    device = resolve_device(device)
    clock = StageClock(device, stage_times)
    print_fn(WELCOME)
    audio, sr, _ = load_audio(audio_file)
    gan = StyleGAN2(model_file, output_size=out_size, device=device, **(stylegan_kwargs or {}))
    session = clock.stage("session", lambda: InteractiveSession(
        audio, sr, fps=fps, seed=seed, segmentation=segmentation, device=device,
        palette_fn=lambda s: gan.mapper(P.seeded_normal(s, (palette_size, gan.z_dim), device)),
        latent_dim=gan.w_dim, latent_layers=gan.num_ws))
    if not clock.stage("repl", lambda: session.repl(input_fn, print_fn)):
        print_fn("quit before final render")
        return None

    names = layer_names(gan.cfg)[1:]
    noise_sizes = [int(names[0].split(".")[0][1:])]  # the coarse layer's noise, as maua_tpu previews it

    def synthesizer(L, N):
        noises = {names[j]: N[f"noise{j}"][:, None] for j in range(len(N))}
        imgs = gan.synthesizer(L, noises=noises or None).permute(0, 2, 3, 1)
        return ((imgs + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    out_file = output_file or f"output/{Path(audio_file).stem}_interactive.mp4"
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    w, h = out_size
    pix_fmt = "yuv420p" if ffmpeg_available() and w % 2 == 0 and h % 2 == 0 else "rgb24"
    print_fn("Rendering final video...")

    def render():
        with VideoWriter(out_file, (w, h), fps, audio_file=audio_file, value_range=(0, 255), pix_fmt=pix_fmt) as vid:
            stream = session.render_final(synthesizer, batch_size=batch_size, fade_time=fade_time,
                                          noise_sizes=noise_sizes)
            for f in pipelined_frames(stream, pix_fmt):
                vid.write(f.tobytes())

    clock.stage("render", render)
    print_fn(out_file)
    return out_file


def main(args=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(description="interactive audio-reactive video synthesis")
    parser.add_argument("--audio_file", required=True, type=str)
    parser.add_argument("--model_file", default=None, type=str)
    parser.add_argument("--output_file", default=None, type=str)
    parser.add_argument("--fps", default=24, type=float)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--segmentation", default="5", type=str,
                        help="int (automatic) or JSON {seconds: label} dict (manual)")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--out_size", default="512,512", type=str)
    parser.add_argument("--fade_time", default=2.0, type=float)
    parser.add_argument("--device", default="cuda", type=str, help="Device to run on (cuda or cpu)")
    args = parser.parse_args(args)

    try:
        segmentation: Union[int, Dict[float, int]] = int(args.segmentation)
    except ValueError:
        segmentation = {float(k): int(v) for k, v in json.loads(args.segmentation).items()}
    out_size = tuple(int(s) for s in args.out_size.split(","))
    generate_interactive(
        args.audio_file, model_file=args.model_file, output_file=args.output_file, fps=args.fps,
        seed=args.seed, segmentation=segmentation, batch_size=args.batch_size,
        out_size=out_size, fade_time=args.fade_time, device=args.device,
    )
    return 0


if __name__ == "__main__":
    main()

"""The canonical audio -> StyleGAN3 recipe.

Port of `maua_tpu/audiovisual/patches/examples/stylegan3.py`: split the
sources, build drum onset, bass and vocal loudness and chroma
envelopes, then mix chroma-weighted latents, spline loops and
onset-driven blends; per-frame translation and rotation (zeros here,
the hook the recipe exposes) drive the alias-free Fourier input.
"""

import torch

from maua_tpu_torch.audiovisual import audioreactive as ar
from maua_tpu_torch.audiovisual.patches.base import StyleGAN3Patch


class ExampleSG3Patch(StyleGAN3Patch):
    def process_audio(self):
        vocals, drums, bass, other = ar.separate_sources(self.audio, self.sr)

        n = self.n_frames
        self.drum_onsets = ar.onsets(drums, self.sr, n, margin=2, clip=95, smooth=2).reshape(-1, 1, 1)
        self.bass_rms = ar.rms(bass, self.sr, n, smooth=20, clip=95, power=1).reshape(-1, 1, 1)
        self.vocal_rms = ar.rms(vocals, self.sr, n, smooth=5, clip=95, power=1).reshape(-1, 1, 1)
        self.vocal_chroma = ar.chroma(vocals, self.sr, n, margin=2)
        self.other_chroma = ar.chroma(other, self.sr, n, margin=2)

    def process_mapper_inputs(self):
        return {"latent_z": self.stylegan3.get_z_latents("1-12,24-36,77-87,777-787,7777-7877")}

    def process_synthesizer_inputs(self, latent_w):
        n = self.n_frames
        vocal_chroma_latents = ar.chroma_weight_latents(self.vocal_chroma, latent_w[:12])
        other_chroma_latents = ar.chroma_weight_latents(self.other_chroma, latent_w[12:24])
        drum_latents = ar.spline_loops(latent_w[24:34], n, n_loops=max(int(self.duration / 7), 1))
        bass_latents = ar.spline_loops(latent_w[34:44], n, n_loops=max(int(self.duration / 5), 1))

        latent_w_plus = ar.spline_loops(latent_w[44:], n, n_loops=1)
        latent_w_plus = (1 - self.vocal_rms) * latent_w_plus + self.vocal_rms * vocal_chroma_latents
        latent_w_plus[:, 10:] = other_chroma_latents[:, 10:]
        latent_w_plus = (1 - self.drum_onsets) * latent_w_plus + self.drum_onsets * drum_latents
        latent_w_plus = (1 - self.bass_rms) * latent_w_plus + self.bass_rms * bass_latents

        return {
            "latent_w_plus": latent_w_plus,
            "translation": torch.zeros(n, 2, device=self.device),
            "rotation": torch.zeros(n, device=self.device),
        }

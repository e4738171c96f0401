"""The port's interactive patch evolution (audiovisual/interactive.py)
against maua_tpu, on the CPU.

Both sessions get the same music information: a stub of random features
and segmentations made from a seed (the MIR itself is held against
maua_tpu in test_torch_selfsupervised.py), handed in by monkeypatching
the name in this test. maua_tpu's draws (palettes from PRNGKey(seed),
each realization's folded keys) are made by JAX and handed to the port
through `seeded_normal` and `Patch.draws`.

Tolerances: labels, sections, commands' effects (subpatches, intensity,
palette rows) identical; EMAFade 1e-6 (maua_tpu carries its average in
f64); latents 1e-5 and noise windows 5e-5 (a Loop's phase magnifies the
one-ulp difference of XLA's f32 cos and torch's, see
test_torch_selfsupervised.py); frames >= 40 dB PSNR.

maua_tpu's `render_final` cuts a bound longer than its label's patch to
the patch's length (the label's first section), so its video comes out
shorter than the audio; the port renders every frame (ROADMAP.md C8).
The comparisons with maua_tpu run on layouts whose repeated labels have
sections of equal length; the C8 layout is asserted against the intended
behaviour.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from maua_tpu.audiovisual import interactive as JI
from maua_tpu.gan import stylegan2 as J2
from maua_tpu_torch import __main__ as cli_main
from maua_tpu_torch import bridge
from maua_tpu_torch.audiovisual import interactive as TI
from maua_tpu_torch.audiovisual.selfsupervised import patch as TP
from maua_tpu_torch.gan import stylegan2 as T2
from test_torch_selfsupervised import SG2_KW, FrameRecorder, JaxDraws, jax_seeded_normal, psnr, test_audio
from test_torch_stylegan2 import random_jax_params

SR = 22050
KS = (2, 4)
DIMS = {"chromagram": 12, "tonnetz": 6, "mfcc": 20, "spectral_contrast": 7, "rms": 1, "drop_strength": 1,
        "onsets": 1, "spectral_flatness": 1}


def stub_mir(seconds: float, seed: int = 0):
    """Random (features, segmentations, tempo) at the MIR's hop of 1024."""
    rs = np.random.RandomState(seed)
    t = int(seconds * SR) // 1024 + 1
    feats = {k: rs.rand(t, d).astype(np.float32) for k, d in DIMS.items()}
    segs = {(k, n): rs.randint(0, n, t) for k in DIMS for n in KS}
    return feats, segs, 121.3


@pytest.fixture
def same_mir(monkeypatch):
    """Both modules' sessions read stub_mir of their audio's length."""
    monkeypatch.setattr(JI, "retrieve_music_information", lambda a, sr: stub_mir(len(a) / sr))

    def torch_stub(a, sr):
        feats, segs, tempo = stub_mir(len(a) / sr)
        return {k: torch.from_numpy(v).to(a.device) for k, v in feats.items()}, segs, tempo

    monkeypatch.setattr(TI, "retrieve_music_information", torch_stub)
    monkeypatch.setattr(TP.Patch, "draws", lambda self, device: JaxDraws(self.seed, device))
    monkeypatch.setattr(TP, "seeded_normal", jax_seeded_normal)


def sessions(seconds, layout, **kw):
    audio = test_audio(seconds)
    j = JI.InteractiveSession(audio, SR, segmentation=layout, seed=0, palette_size=5, latent_dim=16, **kw)
    t = TI.InteractiveSession(audio, SR, segmentation=layout, seed=0, palette_size=5, latent_dim=16, device="cpu",
                              **kw)
    return j, t


@pytest.mark.parametrize("spec", [{0.0: 0, 1.0: 1, 2.0: 0, 3.0: 2}, {0.0: 3, 0.5: 1}, 2, 3, 4])
def test_segment_audio(spec):
    _, segs, _ = stub_mir(4.0)
    audio = np.zeros(4 * SR, np.float32)
    want = JI.segment_audio(audio, SR, 24, spec, segs)
    got = TI.segment_audio(audio, SR, 24, spec, segs)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 96


def test_sections_from_labels():
    labels = np.array([0] * 10 + [1] * 5 + [0] * 7 + [2] * 3 + [1] * 4)
    assert TI.sections_from_labels(labels, 12.0) == JI.sections_from_labels(labels, 12.0)
    sections, bound_labels, bound_times = TI.sections_from_labels(labels, 12.0)
    assert [s[0] for s in sections] == [0, 1, 2] and bound_labels == [0, 1, 0, 2, 1] and len(bound_times) == 6


@pytest.mark.parametrize("fade_frames,total,batch", [(4, 12, 4), (3, 20, 8), (1, 9, 5), (6, 10, 3)])
def test_ema_fade_matches_maua_tpu(fade_frames, total, batch):
    rs = np.random.RandomState(fade_frames)
    jfade, tfade = JI.EMAFade(fade_frames), TI.EMAFade(fade_frames)
    for section in range(3):  # consecutive sections carry the average across their bound
        x = rs.randn(total, 2, 3).astype(np.float32)
        for i in range(0, total, batch):
            want = np.asarray(jfade(x[i : i + batch], i, total))
            got = tfade(torch.from_numpy(x[i : i + batch]), i, total).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"section {section} frame {i}")


def test_commands_and_revert_match_maua_tpu(same_mir):
    j, t = sessions(2.0, {0.0: 0, 0.5: 1, 1.0: 0, 1.5: 2})
    assert t.sections == j.sections and t.bound_labels == j.bound_labels and t.bound_times == j.bound_times

    def same_state():
        for label in j.patches:
            assert t.patches[label].latent_patches == j.patches[label].latent_patches, label
            assert t.patches[label].noise_patches == j.patches[label].noise_patches, label
            assert repr(t.patches[label]) == repr(j.patches[label])
            assert t.intensity[label] == pytest.approx(j.intensity[label], abs=0)
            np.testing.assert_allclose(t.palettes[label].numpy(), np.asarray(j.palettes[label]), rtol=0, atol=0)

    same_state()
    script = ["1", "1", "2", "3", "4", "5", "6", "7", "8", "9", "9", "more", "motion", "style", "less", "show",
              "help", "bogus", "9"]
    for n, command in enumerate(script):
        label = [0, 1, 2][n % 3]
        assert t.apply(command, label) == j.apply(command, label), command
        same_state()
    for label in (0, 1, 2):  # unwind every undo stack
        while j._history[label]:
            assert t.apply("revert", label) == j.apply("revert", label)
        same_state()
        assert t.apply("9", label) == f"section {label}: nothing to revert"


def test_preview_and_patch_save(same_mir, tmp_path):
    j, t = sessions(2.0, {0.0: 0, 1.0: 1})
    want = j.preview(1, noise_sizes=[4], preview_frames=10, save_patch=str(tmp_path / "j.json"))
    got = t.preview(1, noise_sizes=[4], preview_frames=10, save_patch=str(tmp_path / "t.json"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    assert got[0].shape[0] == 10 and len(got[1]) == 1
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_render_final_matches_maua_tpu_on_equal_sections(same_mir):
    j, t = sessions(2.0, {0.0: 0, 0.5: 1, 1.0: 0, 1.5: 1}, fps=12)
    for label in (0, 1):  # evolve both the same way first
        j.apply("1", label)
        t.apply("1", label)
    want = list(j.render_final(lambda L, N: (np.asarray(L), {k: np.asarray(v) for k, v in N.items()}),
                               batch_size=4, fade_time=0.25))
    got = list(t.render_final(lambda L, N: (L.numpy(), {k: v.numpy() for k, v in N.items()}),
                              batch_size=4, fade_time=0.25))
    assert len(got) == len(want) == 8 and sum(len(b[0]) for b in got) == len(t.labels) == 24
    for n, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-5, err_msg=f"latents, batch {n}")
        assert sorted(gn) == sorted(wn) == ["noise0"]
        for k in gn:
            np.testing.assert_allclose(gn[k], wn[k], rtol=0, atol=5e-5, err_msg=f"{k}, batch {n}")


def test_render_final_covers_every_frame_of_the_timeline(same_mir):
    """Layout A B A over 4 s at 24 fps: the second A lasts 2 s, its patch
    (the first A's) 1 s. maua_tpu renders 72 frames, cutting the second A
    to 1 s; the port renders all 96, the second A's patch wrapped."""
    j, t = sessions(4.0, {0.0: 0, 1.0: 1, 2.0: 0})
    assert len(t.labels) == len(j.labels) == 96 and t.bound_labels == [0, 1, 0]
    assert sum(b.shape[0] for b in j.render_final(lambda L, N: np.asarray(L), batch_size=8, fade_time=0.25)) == 72

    latents, noises = [], []
    for L, N in t.render_final(lambda L, N: (L, N["noise0"]), batch_size=8, fade_time=0.25):
        latents.append(L)
        noises.append(N)
    latents, noises = torch.cat(latents), torch.cat(noises)
    assert latents.shape[0] == noises.shape[0] == 96
    fade = 6  # fade_time 0.25 s at 24 fps: EMAFade touches the first and last 6 frames of each bound
    for label, start, end in zip(t.bound_labels, t.bound_times[:-1], t.bound_times[1:]):
        lats, mods = t.patches[label](t.palettes[label], noise_sizes=[4])
        n = round((end - start) * 24)
        frames = torch.arange(n) % lats.shape[0]
        first = round(start * 24)
        inner = slice(fade + 1, n - fade)
        torch.testing.assert_close(latents[first : first + n][inner], lats[frames][inner], rtol=0, atol=0)
        torch.testing.assert_close(noises[first : first + n][inner], mods[0](0, n)[inner], rtol=0, atol=1e-6)
    assert lats.shape[0] == 24  # the second A (48 frames) wrapped its 24-frame patch


def test_generate_interactive_matches_maua_tpu(same_mir, tmp_path, monkeypatch):
    wav = str(tmp_path / "i.wav")
    wavfile.write(wav, SR, test_audio(2.0))
    cfg = J2.SG2Config(**SG2_KW)
    params = random_jax_params(cfg, 13)

    class JaxRecorder(FrameRecorder):
        pass

    class TorchRecorder(FrameRecorder):
        pass

    from maua_tpu.ops import video as JV  # maua_tpu's generate_interactive imports it when called

    monkeypatch.setattr(JV, "VideoWriter", JaxRecorder)
    monkeypatch.setattr(TI, "VideoWriter", TorchRecorder)
    # at the net's own size: an output resize refills every resized layer's noise with random draws, which
    # differ between the packages (tests/test_torch_resize.py); the resized render is checked below
    kw = dict(fps=12, seed=0, segmentation={0.0: 0, 1.0: 1}, batch_size=4, out_size=(32, 32), fade_time=0.5,
              palette_size=4)
    printed = {"j": [], "t": []}
    script = ["1,3", "next", "7", "9", "5", "next"]
    j_in, t_in = iter(script), iter(script)
    JI.generate_interactive(wav, output_file=str(tmp_path / "j.mp4"), stylegan_kwargs={"cfg": cfg, "params": params},
                            input_fn=lambda _: next(j_in), print_fn=printed["j"].append, **kw)
    stages = {}
    out = TI.generate_interactive(
        wav, output_file=str(tmp_path / "t.mp4"), device="cpu", input_fn=lambda _: next(t_in),
        print_fn=printed["t"].append, stage_times=stages,
        stylegan_kwargs={"cfg": T2.SG2Config(**SG2_KW), "params": bridge.params_to_torch(params)}, **kw)
    want, got = np.stack(JaxRecorder.frames), np.stack(TorchRecorder.frames)
    assert out == str(tmp_path / "t.mp4") and printed["t"][:-1] == printed["j"][:-1] and printed["t"][-1] == out
    assert got.shape == want.shape == (24, 32, 32, 3) and got.std() > 1.0
    assert psnr(got, want) >= 40.0, psnr(got, want)
    assert set(stages) == {"session", "repl", "render"}
    t_in = iter(script)
    TI.generate_interactive(wav, output_file=str(tmp_path / "r.mp4"), device="cpu", input_fn=lambda _: next(t_in),
                            print_fn=printed["t"].append,
                            stylegan_kwargs={"cfg": T2.SG2Config(**SG2_KW), "params": bridge.params_to_torch(params)},
                            **{**kw, "out_size": (40, 48)})
    resized = np.stack(TorchRecorder.frames)
    assert resized.shape == (24, 48, 40, 3) and resized.std() > 1.0


def test_generate_interactive_quits_and_needs_a_card(same_mir, tmp_path):
    wav = str(tmp_path / "q.wav")
    wavfile.write(wav, SR, test_audio(1.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TI.generate_interactive(wav, input_fn=lambda _: "quit")
        with pytest.raises(RuntimeError, match="CUDA"):
            TI.InteractiveSession(test_audio(1.0), SR, segmentation={0.0: 0})
    cfg = T2.SG2Config(**SG2_KW)
    printed = []
    assert TI.generate_interactive(wav, device="cpu", input_fn=lambda _: "quit", print_fn=printed.append,
                                   stylegan_kwargs={"cfg": cfg}, segmentation={0.0: 0}) is None
    assert printed[-1] == "quit before final render"


def test_cli_parses_the_interactive_command(monkeypatch):
    seen = {}
    monkeypatch.setattr(TI, "generate_interactive", lambda *a, **kw: seen.update(args=a, kw=kw))
    cli_main.main(["audiovisual", "interactive", "--audio_file", "s.wav", "--segmentation", '{"0": 0, "2.5": 1}',
                   "--out_size", "640,360", "--device", "cpu"])
    assert seen["args"] == ("s.wav",)
    assert seen["kw"]["segmentation"] == {0.0: 0, 2.5: 1} and seen["kw"]["out_size"] == (640, 360)
    assert seen["kw"]["device"] == "cpu" and seen["kw"]["fade_time"] == 2.0
    cli_main.main(["audiovisual", "interactive", "--audio_file", "s.wav"])
    assert seen["kw"]["segmentation"] == 5 and seen["kw"]["device"] == "cuda"

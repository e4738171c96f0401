"""The port's CLI tree, its small helpers and the mesh's remaining callers, against maua_tpu's, on the CPU.

The CLI: `maua_tpu_torch/cli/entrypoint.py` keeps maua_tpu's command tree
(the same commands and subcommands, with `serve http` and `dataset
retrieve`), its usage, return codes and default-subcommand rule. The
helpers (`utility`, `ops/io`, `ops/signal`, `audio/io`, `audio/constantq`,
`oom`) on the same inputs as maua_tpu's: exact where they are host code,
1e-5 of the largest magnitude for the pseudo-CQT (f32 FFTs in another
order). `upscale_bulk_sharded` on a logical data axis equals `upscale`, and
`ImageDataset(mesh=)` delivers the batches `device=` does.
"""

import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu import oom as JOOM
from maua_tpu import utility as JU
from maua_tpu.audio import constantq as JCQ
from maua_tpu.audio import io as JAIO
from maua_tpu.cli import entrypoint as JE
from maua_tpu.ops import io as JIO
from maua_tpu.ops import signal as JSIG
from maua_tpu_torch import __main__ as port_main
from maua_tpu_torch import oom as TOOM
from maua_tpu_torch import utility as TU
from maua_tpu_torch.audio import constantq as TCQ
from maua_tpu_torch.audio import io as TAIO
from maua_tpu_torch.cli import entrypoint as TE
from maua_tpu_torch.cli import lazy
from maua_tpu_torch.gan import data as TD
from maua_tpu_torch.ops import io as TIO
from maua_tpu_torch.ops import signal as TSIG
from maua_tpu_torch.parallel.mesh import make_mesh
from maua_tpu_torch.super import image as TSI

torch.set_num_threads(1)


# ------------------------------------------------------------------ the CLI
def test_command_tree_is_maua_tpus():
    assert list(TE.COMMANDS) == list(JE.COMMANDS)
    for cmd, subs in JE.COMMANDS.items():
        assert list(TE.COMMANDS[cmd]) == list(subs), cmd
        for sub, (module, desc) in subs.items():
            assert TE.COMMANDS[cmd][sub] == (module.replace("maua_tpu.", "maua_tpu_torch.", 1), desc)
    assert port_main.COMMANDS[("serve", "http")] == "maua_tpu_torch.serve"
    assert port_main.COMMANDS[("dataset", "retrieve")] == "maua_tpu_torch.dataset.laion_clip_retrieval"


@pytest.mark.parametrize("argv,rc", [([], 0), (["-h"], 0), (["--help"], 0), (["bogus"], 1)])
def test_usage_and_return_codes(capsys, argv, rc):
    assert TE.main(argv) == rc
    out = capsys.readouterr().out
    assert "usage: python -m maua_tpu_torch <command> <subcommand>" in out and "serve http" in out
    assert ("unknown command 'bogus'" in out) == (rc == 1)


@pytest.fixture
def dispatched(monkeypatch):
    """Every subcommand module's main replaced by a recorder of (module, argv)."""
    import importlib

    seen = []

    class Recorder:
        def __init__(self, name):
            self.name = name

        def main(self, argv):
            seen.append((self.name, argv))
            return 0

    monkeypatch.setattr(importlib, "import_module", lambda name: Recorder(name))
    monkeypatch.delenv("MAUA_PLATFORM", raising=False)
    return seen


@pytest.mark.parametrize("argv,module,rest", [
    (["serve", "http", "--port", "0"], "maua_tpu_torch.serve", ["--port", "0"]),
    (["dataset", "retrieve", "--texts", "a"], "maua_tpu_torch.dataset.laion_clip_retrieval", ["--texts", "a"]),
    (["gan", "--seeds", "0-2"], "maua_tpu_torch.gan.cli", ["--seeds", "0-2"]),  # the default subcommand
    (["autoregressive", "finetune", "--steps", "3"], "maua_tpu_torch.autoregressive.cli",
     ["finetune", "--steps", "3"]),  # reaches generate's own subcommand
    (["autoregressive", "rq", "a fox"], "maua_tpu_torch.autoregressive.cli", ["rq", "a fox"]),
    (["nca"], "maua_tpu_torch.nca.nca", []),
])
def test_dispatch_and_aliases(dispatched, argv, module, rest):
    assert TE.main(argv) == 0 and port_main.main(argv) == 0
    assert dispatched == [(module, rest)] * 2


def test_maua_platform_asks_for_the_cpu(dispatched, monkeypatch):
    monkeypatch.setenv("MAUA_PLATFORM", "cpu")
    TE.main(["super", "image", "in.png"])
    TE.main(["gan", "generate", "--device", "cuda"])  # an explicit device wins
    TE.main(["dataset", "retrieve", "--texts", "a"])  # no model, no --device
    assert dispatched == [("maua_tpu_torch.super.image", ["in.png", "--device", "cpu"]),
                          ("maua_tpu_torch.gan.cli", ["--device", "cuda"]),
                          ("maua_tpu_torch.dataset.laion_clip_retrieval", ["--texts", "a"])]


def test_every_subcommand_module_has_a_main():
    import importlib

    for cmd, subs in TE.COMMANDS.items():
        for sub, (module, _) in subs.items():
            assert callable(importlib.import_module(module).main), (cmd, sub)


def test_lazy_imports_at_the_call():
    assert lazy("maua_tpu_torch.utility", "name")("a/b/clip.mp4") == "clip"


def test_serve_http_parses_its_flags(monkeypatch):
    from maua_tpu_torch import serve

    seen = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            seen["closed"] = True

    monkeypatch.setattr(serve, "build_services", lambda args: seen.setdefault("args", args) and {})
    monkeypatch.setattr(serve, "make_http_server", lambda services, host, port: Server())
    assert TE.main(["serve", "http", "--port", "0", "--diffusion", "--timesteps", "4", "--device", "cpu"]) == 0
    args = seen["args"]
    assert args.port == 0 and args.diffusion and args.timesteps == 4 and args.device == "cpu" and seen["closed"]
    assert serve.main.__module__ == "maua_tpu_torch.serve"


# ------------------------------------------------------------------ helpers
def test_utility_helpers_match_maua_tpus(tmp_path, capsys):
    for s in ("a/b/c.tar.gz", "x.png", "noext"):
        assert TU.name(s) == JU.name(s)
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    TU.info(torch.from_numpy(a), a * 2, label="x")
    JU.info(a, a * 2, label="x")
    got, want = capsys.readouterr().out.splitlines()
    assert got == want
    for args in ((a,), ("key", a, b"raw"), (a.astype(np.float64),)):
        assert TU.content_hash(*args) == JU.content_hash(*args)
    assert TU.content_hash(torch.from_numpy(a)) == JU.content_hash(a)
    TU.seed_everything(7)
    x = (np.random.rand(), torch.rand(1).item())
    TU.seed_everything(7)
    assert (np.random.rand(), torch.rand(1).item()) == x
    assert torch.equal(torch.rand(3, generator=TU.rng(5)), torch.rand(3, generator=torch.Generator().manual_seed(5)))
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as zf:
        zf.writestr("d/f.txt", "hi")
    TU.unzip(str(tmp_path / "a.zip"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "d" / "f.txt").read_text() == "hi"


def test_image_io_helpers_match_maua_tpus():
    imgs = np.random.RandomState(1).rand(2, 5, 6, 3).astype(np.float32)
    for got, want in zip(TIO.tensor2imgs(torch.from_numpy(imgs)), JIO.tensor2imgs(imgs)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    for rng in ((0, 1), (-1, 1)):
        assert TIO.tensor2bytes(torch.from_numpy(imgs[:1]), rng) == JIO.tensor2bytes(imgs[:1], rng)
    for obj in (imgs, 3, "s", np.zeros(4)):
        assert TIO.content_hash(obj) == JIO.content_hash(obj)
    assert TIO.content_hash(torch.from_numpy(imgs)) == JIO.content_hash(imgs)


def test_signal_helpers_match_maua_tpus():
    x = np.random.RandomState(2).rand(37, 3).astype(np.float32)
    for p in (0, 25, 50, 95, 100):
        assert float(TSIG.percentile(torch.from_numpy(x), p)) == float(JSIG.percentile(jnp.asarray(x), p))
    np.testing.assert_allclose(TSIG.expand(torch.from_numpy(x), 0.5, 2.0).numpy(),
                               np.asarray(JSIG.expand(jnp.asarray(x), 0.5, 2.0)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(TSIG.resample(torch.from_numpy(x), 50).numpy(),
                               np.asarray(JSIG.resample(jnp.asarray(x), 50)), atol=1e-6, rtol=0)
    assert TSIG.resample is TSIG.resample_1d


def test_pseudo_cqt_matches_maua_tpus():
    y = np.random.RandomState(3).randn(22050).astype(np.float32)
    kw = dict(sr=22050, hop_length=512, n_bins=24, bins_per_octave=12, fmin=110.0)
    want = np.asarray(JCQ.pseudo_cqt(jnp.asarray(y), **kw))
    got = TCQ.pseudo_cqt(torch.from_numpy(y), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_shrinking_batches_match_maua_tpus():
    for n, b, m in ((10, 16, 1), (10, 12, 3), (1, 1, 1)):
        assert list(TOOM.shrinking_batches(n, b, m)) == list(JOOM.shrinking_batches(n, b, m))


def test_audio_caches_in_the_workspace(tmp_path, monkeypatch):
    from scipy.io import wavfile

    wav = tmp_path / "tone.wav"
    wavfile.write(wav, 8000, (np.sin(np.arange(8000) / 5) * 2 ** 14).astype(np.int16))
    monkeypatch.setattr(TU, "WORKSPACE", str(tmp_path / "ws"))
    monkeypatch.setattr(JAIO, "WORKSPACE", str(tmp_path / "jws"))
    a, sr, dur = TAIO.load_audio(str(wav), duration=0.5)
    assert not (tmp_path / "ws").exists()  # no cache unless asked
    b = TAIO.load_audio(str(wav), duration=0.5, cache=True)
    want = JAIO.load_audio(str(wav), duration=0.5, cache=True)
    assert np.array_equal(a, b[0]) and np.array_equal(a, want[0]) and (sr, dur) == b[1:] == want[1:]
    assert os.listdir(tmp_path / "ws" / "audio_cache") == os.listdir(tmp_path / "jws" / "audio_cache")
    assert np.array_equal(TAIO.load_audio(str(wav), duration=0.5, cache=True)[0], a)  # read back

    calls = []

    @TAIO.cache_to_workspace("feat")
    def feature(x, k=2):
        calls.append(k)
        return x * k, np.float32(k)

    x = np.arange(5, dtype=np.float32)
    first = feature(x, k=3)
    again = feature(x, k=3)
    assert calls == [3] and np.array_equal(first[0], again[0]) and float(again[1]) == 3
    feature(x, k=3, cache=False)
    feature(torch.from_numpy(x), k=4)
    assert calls == [3, 3, 4]
    assert len(os.listdir(tmp_path / "ws" / "feature_cache")) == 2


# ------------------------------------------------------------------ the mesh's callers
def test_upscale_bulk_sharded_equals_upscale():
    up = TSI.Upscaler("waifu2x-anime-noise0", device="cpu")
    imgs = [np.random.RandomState(i).rand(1, 12, 10, 3).astype(np.float32) for i in range(5)]
    want = list(TSI.upscale(imgs, model=up))
    mesh = make_mesh(2, devices=["cpu"] * 2)  # a logical data axis of 2: batches of 3 pad to 4
    got = list(TSI.upscale_bulk_sharded(imgs, batch_size=3, mesh=mesh, model=up))
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.shape == (1, 24, 20, 3) and np.array_equal(a, b)
    spread = make_mesh(devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="distinct devices"):
        list(TSI.upscale_bulk_sharded(imgs, mesh=spread, model=up))


def test_image_dataset_takes_a_mesh(tmp_path):
    cache = tmp_path / "imgs.npy"
    np.save(cache, (np.random.RandomState(0).rand(6, 8, 8, 3) * 255).astype(np.uint8))
    plain = list(TD.ImageDataset(str(cache), 2, seed=1, prefetch=0, device="cpu"))
    meshed = list(TD.ImageDataset(str(cache), 2, 1, make_mesh(2, devices=["cpu"] * 2), prefetch=1))
    assert len(plain) == len(meshed) == 3
    for a, b in zip(plain, meshed):
        assert torch.equal(a, b) and b.device.type == "cpu"

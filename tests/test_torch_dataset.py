"""The port's dataset tools (maua_tpu_torch/dataset) against maua_tpu's, on the CPU.

Multi-crop: JAX's three uniforms of each crop (rebuilt from maua_tpu's key
schedule) handed to the port's crop arithmetic; crops within 1e-5 of
maua_tpu's (f32 bilinear taps). The ranker: a tiny CLIP (the guidance tests'
towers) with an aesthetic head brought over by the bridge; scores within
1e-5, the same order. The scraper: maua_tpu's cases with stubbed
transports, nothing fetched, and the port's wire payloads equal to
maua_tpu's.
"""

import base64
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maua_tpu.dataset import laion_clip_retrieval as JL
from maua_tpu.dataset import multicrop as JM
from maua_tpu.dataset import ranker as JR
from maua_tpu.perceptors import clip as JCLIP
from maua_tpu.text import clip_text as JT
from maua_tpu_torch import bridge
from maua_tpu_torch.dataset import laion_clip_retrieval as TL
from maua_tpu_torch.dataset import multicrop as TM
from maua_tpu_torch.dataset import ranker as TR
from maua_tpu_torch.perceptors import clip as TCLIP
from maua_tpu_torch.text import clip_text as TT
from test_torch_diffusion import TINY_TEXT, port_cfg, random_params

torch.set_num_threads(1)

TINY_VISION = JCLIP.CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=4, embed_dim=64)


def jax_uniforms(key):
    """The three uniforms maua_tpu's random_resized_crop draws from `key` (area, top, left), in [0, 1)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.array([float(jax.random.uniform(k, ())) for k in (k1, k2, k3)], np.float32)


@pytest.mark.parametrize("size,out,scale", [((40, 52), 24, (0.14, 1.0)), ((33, 33), 16, (0.05, 0.14)),
                                            ((20, 64), 32, (0.5, 1.0))])
def test_crop_arithmetic_matches_maua_tpu_with_its_uniforms(size, out, scale):
    h, w = size
    img = np.random.RandomState(h).rand(h, w, 3).astype(np.float32)
    crop = jax.jit(JM.random_resized_crop, static_argnames=("out_size", "scale"))
    keys = [jax.random.PRNGKey(i) for i in range(4)]
    want = np.stack([np.asarray(crop(k, jnp.asarray(img), out_size=out, scale=scale)) for k in keys])
    u = torch.from_numpy(np.stack([jax_uniforms(k) for k in keys]))
    batch = torch.from_numpy(img).permute(2, 0, 1)[None].expand(4, -1, -1, -1)
    got = TM.random_resized_crop_at(batch, out, u, scale).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_crop_is_differentiable_and_drawn_from_a_generator():
    img = torch.rand(2, 3, 20, 20, generator=torch.Generator().manual_seed(0), requires_grad=True)
    a = TM.random_resized_crop(img, 8, torch.Generator().manual_seed(1))
    b = TM.random_resized_crop(img, 8, torch.Generator().manual_seed(1))
    assert a.shape == (2, 3, 8, 8) and torch.equal(a, b)
    (g,) = torch.autograd.grad(a.sum(), img)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_multicrop_dataset_batches():
    images = np.random.RandomState(0).rand(10, 24, 28, 3).astype(np.float32)
    ds = TM.MultiCropDataset(images, size_crops=(16, 8), n_crops=(2, 3), batch_size=4, seed=3, device="cpu")
    jds = JM.MultiCropDataset(images, size_crops=(16, 8), n_crops=(2, 3), batch_size=4, seed=3)
    assert len(ds) == len(jds) == 2
    batches = list(ds)
    assert len(batches) == 2 and [tuple(c.shape) for c in batches[0]] == [(4, 3, 16, 16)] * 2 + [(4, 3, 8, 8)] * 3
    assert all(0 <= float(c.min()) and float(c.max()) <= 1 for b in batches for c in b)
    # the epoch's permutation is numpy's default_rng(seed), as maua_tpu's
    fresh = [cls(images, size_crops=(16, 8), n_crops=(2, 3), batch_size=4, seed=3, **kw).rng.permutation(10)
             for cls, kw in ((TM.MultiCropDataset, {"device": "cpu"}), (JM.MultiCropDataset, {}))]
    assert np.array_equal(*fresh)
    again = list(TM.MultiCropDataset(images, size_crops=(16, 8), n_crops=(2, 3), batch_size=4, seed=3, device="cpu"))
    assert all(torch.equal(x, y) for b, c in zip(batches, again) for x, y in zip(b, c))
    # the first batch replayed: the crops' uniforms, then a flip each, from the generator in turn
    gen = torch.Generator().manual_seed(3)
    first = torch.from_numpy(images[np.sort(np.random.default_rng(3).permutation(10)[:4])]).permute(0, 3, 1, 2)
    for crop, size in zip(batches[0], (16, 16, 8, 8, 8)):
        u = torch.rand((4, 3), generator=gen)
        flip = torch.rand(4, generator=gen) < 0.5
        want = TM.random_resized_crop_at(first, size, u, (0.14, 1.0) if size == 16 else (0.05, 0.14))
        torch.testing.assert_close(crop, torch.where(flip[:, None, None, None], want.flip(-1), want), rtol=0, atol=0)


@pytest.fixture(scope="module")
def rankers():
    vision = random_params(lambda k: JCLIP.init_vision_params(k, TINY_VISION), 30)
    text = random_params(lambda k: JT.init_params(k, TINY_TEXT), 31)
    proj = np.random.RandomState(32).randn(TINY_TEXT.width, TINY_VISION.embed_dim).astype(np.float32) / 8
    rs = np.random.RandomState(33)
    w, b = rs.randn(64, 1).astype(np.float32) * 0.5, rs.randn(1).astype(np.float32) * 0.1
    jp = JCLIP.AestheticPerceptor(head={"w": jnp.asarray(w), "b": jnp.asarray(b)}, vision_params=vision,
                                  vision_cfg=TINY_VISION, text_params=text, text_cfg=TINY_TEXT,
                                  text_proj=jnp.asarray(proj))
    tp = TCLIP.AestheticPerceptor(head={"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                                  vision_params=bridge.guidance_params_to_torch(vision),
                                  vision_cfg=port_cfg(TCLIP.CLIPVisionConfig, TINY_VISION),
                                  text_params=bridge.diffusion_params_to_torch(text),
                                  text_cfg=port_cfg(TT.CLIPTextConfig, TINY_TEXT), text_proj=proj, device="cpu")
    return JR.ImageRanker(jp, aesthetic_weight=0.7), TR.ImageRanker(tp, aesthetic_weight=0.7)


@pytest.mark.parametrize("prompt", [None, "a red fox in the snow"])
def test_ranker_scores_and_order_match_maua_tpu(rankers, prompt):
    jr, tr = rankers
    imgs = np.random.RandomState(5).rand(6, 32, 32, 3).astype(np.float32) * 2 - 1
    want = jr.score(imgs, prompt)
    got = tr.score(imgs, prompt)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.array_equal(tr.rank(imgs, prompt), jr.rank(imgs, prompt))
    assert len(set(np.round(got, 4))) == 6  # distinct scores: the order is not a tie-break


# ------------------------------------------------------------------ the scraper
KNN_CASES = [dict(text="a blue dog", num_images=7), dict(text="x", aesthetic_score=0),
             dict(image_url="http://seed.jpg", modality="text", index="laion_400m", multilingual=True,
                  deduplicate=False, safety=True, violence_filter=False, aesthetic_weight=0.25)]


@pytest.mark.parametrize("case", range(len(KNN_CASES)))
def test_knn_payload_equals_maua_tpus(case):
    assert TL.build_knn_payload(**KNN_CASES[case]) == JL.build_knn_payload(**KNN_CASES[case])


def test_knn_payload_wire_format_and_image_prompt(tmp_path):
    payload = json.loads(TL.build_knn_payload(text="a blue dog", num_images=7))
    assert payload["text"] == "a blue dog" and payload["image"] is None and payload["image_url"] is None
    assert payload["num_images"] == 7 and payload["num_result_ids"] == 7 and payload["indice_name"] == "laion5B"
    assert payload["aesthetic_score"] == "9" and payload["aesthetic_weight"] == "0.5"
    assert json.loads(TL.build_knn_payload(text="x", aesthetic_score=0))["aesthetic_score"] == '""'
    f = tmp_path / "img.bin"
    f.write_bytes(b"\x89PNG\r\n\x1a\nxyz")
    payload = json.loads(TL.build_knn_payload(image_file=str(f)))
    assert base64.b64decode(payload["image"]) == b"\x89PNG\r\n\x1a\nxyz" and payload["text"] is None


def test_parse_knn_response_dedups_in_order():
    raw = json.dumps([{"url": "http://a/1.jpg", "similarity": 0.9}, {"url": "http://b/2.jpg"},
                      {"url": "http://a/1.jpg"}, {"caption": "no url row"}])
    assert TL.parse_knn_response(raw) == JL.parse_knn_response(raw) == ["http://a/1.jpg", "http://b/2.jpg"]
    with pytest.raises(ValueError):
        TL.parse_knn_response(json.dumps({"not": "a list"}))


def test_retrieve_merges_prompts_through_a_stub():
    posts = []

    def fake_post(url, data):
        posts.append((url, json.loads(data)))
        return json.dumps([{"url": f"http://img/{len(posts)}.jpg"}, {"url": "http://img/shared.jpg"}])

    urls = TL.retrieve(texts=["cat"], urls=["http://seed.jpg"], http_post=fake_post)
    assert posts[0][0] == TL.KNN_ENDPOINT == JL.KNN_ENDPOINT
    assert posts[0][1]["text"] == "cat" and posts[1][1]["image_url"] == "http://seed.jpg"
    assert urls == ["http://img/1.jpg", "http://img/shared.jpg", "http://img/2.jpg"]
    with pytest.raises(ValueError, match="prompt"):
        TL.retrieve(http_post=fake_post)


def test_file_names_and_sniffer():
    png = b"\x89PNG\r\n\x1a\n" + b"0" * 16
    for blob, ext in ((png, "png"), (b"\xff\xd8\xff\xe0rest", "jpg"), (b"RIFF....WEBPrest", "webp"),
                      (b"GIF89a..", "gif"), (b"plain text", None)):
        assert TL.sniff_extension(blob) == JL.sniff_extension(blob) == ext
    cd = {"Content-Disposition": 'attachment; filename="My Pic.jpeg"'}
    assert TL.filename_for("http://x/path/photo%20one.jpeg", cd, png) == "My_Pic.png"
    assert TL.filename_for("http://x/photo%20one.jpeg", {}, png) == "photo_one.png"


def _png(h, w):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def test_download_filters_by_size_through_a_stub(tmp_path):
    assert TL.image_size_from_bytes(_png(12, 34)) == (34, 12) and TL.image_size_from_bytes(b"nope") == (-1, -1)
    blobs = {"http://x/big.png": _png(64, 64), "http://x/small.png": _png(8, 8)}
    ranges = []

    def fake_get(url, byte_range=None):
        ranges.append(byte_range)
        return blobs[url], {"Content-Type": "image/png"}

    assert TL.download(list(blobs), str(tmp_path), min_size=32, http_get=fake_get, workers=2) == 1
    assert (tmp_path / "big.png").exists() and not (tmp_path / "small.png").exists()
    assert "bytes=0-2000000" in ranges


def test_laion_retrieval_end_to_end_with_stubs(tmp_path):
    def fake_post(url, data):
        return json.dumps([{"url": "http://x/a.png"}, {"url": "http://x/b.png"}])

    def fake_get(url, byte_range=None):
        return _png(40, 40), {}

    n = TR.laion_clip_retrieval(texts=["a fox"], out_dir=str(tmp_path), min_size=16, http_post=fake_post,
                                http_get=fake_get)
    assert n == 2 and sorted(p.name for p in tmp_path.iterdir()) == ["a.png", "b.png"]


def test_retrieve_command_with_stubbed_transports(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(TL, "_default_post", lambda url, data: json.dumps([{"url": "http://x/c.png"}]))
    monkeypatch.setattr(TL, "_default_get", lambda url, byte_range=None: (_png(20, 20), {}))
    from maua_tpu_torch.cli.entrypoint import main

    assert main(["dataset", "retrieve", "--texts", "a cat", "--out_dir", str(tmp_path)]) == 0
    assert (tmp_path / "c.png").exists() and "Downloaded 1 images." in capsys.readouterr().out

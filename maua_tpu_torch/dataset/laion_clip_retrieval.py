"""LAION CLIP-retrieval scraper.

The port's own copy of `maua_tpu/dataset/laion_clip_retrieval.py` (which
imports no JAX): query the knn5.laion.ai CLIP-retrieval service with text,
image or url prompts and bulk-download the candidate images. The request,
response and file-name logic is pure; the two network touchpoints take
injectable transports (`http_post` / `http_get`), so tests and hosts
without network stub them.

    python -m maua_tpu_torch dataset retrieve --texts "a red fox" --out_dir foxes/ --size 512
"""

from __future__ import annotations

import base64
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import unquote, urlparse

KNN_ENDPOINT = "https://knn5.laion.ai/knn-service"
USER_AGENT = {"User-Agent": "Maua", "From": "https://github.com/maua-maua-maua/maua"}


# ------------------------------------------------------------- request
def encode_image_prompt(file: Optional[str]) -> Optional[str]:
    """Base64-encode an image file for the knn payload
    (`laion_clip_retrieval.py:31-35`)."""
    if file is None:
        return None
    with open(file, "rb") as fh:
        return base64.b64encode(fh.read()).decode("utf-8")


def build_knn_payload(
    text: Optional[str] = None,
    image_file: Optional[str] = None,
    image_url: Optional[str] = None,
    modality: str = "image",
    num_images: int = 40,
    index: str = "laion5B",
    multilingual: bool = False,
    deduplicate: bool = True,
    safety: bool = False,
    violence_filter: bool = True,
    aesthetic_score: int = 9,
    aesthetic_weight: float = 0.5,
) -> str:
    """Serialize one knn-service query (`laion_clip_retrieval.py:66-90`).

    Matches the service's accepted wire format, including its quirks:
    aesthetic knobs ship as STRINGS ('9', '0.5'; '""' disables), and
    the reference strips spaces from the JSON (the text is substituted
    afterwards so prompt spaces survive — reproduced here by building
    compact JSON and letting json.dumps escape the text properly)."""
    body: Dict = {
        "text": text,
        "image": encode_image_prompt(image_file),
        "image_url": image_url,
        "embedding_input": None,
        "modality": modality,
        "num_images": num_images,
        "indice_name": index,
        "num_result_ids": num_images,
        "use_mclip": multilingual,
        "deduplicate": deduplicate,
        "use_safety_model": safety,
        "use_violence_detector": violence_filter,
        "aesthetic_score": str(aesthetic_score) if aesthetic_score else '""',
        "aesthetic_weight": str(aesthetic_weight),
    }
    return json.dumps(body, separators=(",", ":"))


def parse_knn_response(payload) -> List[str]:
    """knn-service response -> unique candidate URLs, order-preserving
    (`laion_clip_retrieval.py:92-93` uses np.unique; order-preserving
    dedup keeps the service's similarity ranking instead of sorting
    alphabetically). Accepts raw JSON text/bytes or the decoded list."""
    if isinstance(payload, (bytes, str)):
        payload = json.loads(payload)
    if not isinstance(payload, list):
        raise ValueError(f"unexpected knn response type {type(payload).__name__}")
    seen, urls = set(), []
    for row in payload:
        url = row.get("url") if isinstance(row, dict) else None
        if url and url not in seen:
            seen.add(url)
            urls.append(url)
    return urls


# ------------------------------------------------------------ download
_MAGIC = [
    (b"\xff\xd8\xff", "jpg"),
    (b"\x89PNG\r\n\x1a\n", "png"),
    (b"GIF87a", "gif"),
    (b"GIF89a", "gif"),
    (b"BM", "bmp"),
]


def sniff_extension(content: bytes) -> Optional[str]:
    """Magic-number file-type guess (the reference uses the `filetype`
    package, `laion_clip_retrieval.py:117`)."""
    for magic, ext in _MAGIC:
        if content[: len(magic)] == magic:
            return ext
    if len(content) >= 12 and content[:4] == b"RIFF" and content[8:12] == b"WEBP":
        return "webp"
    return None


def filename_for(url: str, headers: Dict[str, str], content: bytes) -> str:
    """Pick an output file name (`laion_clip_retrieval.py:107-119`):
    prefer the server's Content-Disposition, fall back to the URL path,
    then fix the extension from the content's magic bytes."""
    fname = Path(urlparse(url).path).name or "image"
    cd = headers.get("Content-Disposition") or headers.get("content-disposition")
    if cd and "filename=" in cd:
        fname = cd.split("filename=")[1]
    fname = unquote(fname).strip('"').strip().replace(" ", "_")
    ext = sniff_extension(content)
    if ext is not None:
        stem = "_".join(fname.split(".")[:-1]) or fname
        fname = f"{stem}.{ext}"
    return re.sub(r"[^\w.\-]", "_", fname)


def image_size_from_bytes(data: bytes) -> Tuple[int, int]:
    """Image dimensions from a (possibly truncated) byte prefix
    (`laion_clip_retrieval.py:20-28` feeds a ranged GET into PIL's
    incremental parser). (-1, -1) when no header parses."""
    from PIL import ImageFile

    p = ImageFile.Parser()
    try:
        p.feed(data)
    except Exception:
        return (-1, -1)
    return p.image.size if p.image else (-1, -1)


def _default_post(url: str, data: str) -> bytes:
    import urllib.request

    req = urllib.request.Request(
        url, data=data.encode(), headers={**USER_AGENT, "Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def _default_get(url: str, byte_range: Optional[str] = None):
    import urllib.request

    headers = dict(USER_AGENT)
    if byte_range:
        headers["Range"] = byte_range
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read(), dict(resp.headers)


def retrieve(
    texts: Sequence[str] = (),
    images: Sequence[str] = (),
    urls: Sequence[str] = (),
    http_post: Optional[Callable[[str, str], bytes]] = None,
    **query_kwargs,
) -> List[str]:
    """Query the knn service once per prompt and merge candidates
    (`laion_clip_retrieval.py:62-94`)."""
    if not (texts or images or urls):
        raise ValueError("At least one text, image, or url prompt must be supplied!")
    post = http_post or _default_post
    prompts = (
        [{"text": t} for t in texts]
        + [{"image_file": i} for i in images]
        + [{"image_url": u} for u in urls]
    )
    candidates: List[str] = []
    for prompt in prompts:
        payload = build_knn_payload(**prompt, **query_kwargs)
        candidates.extend(parse_knn_response(post(KNN_ENDPOINT, payload)))
    return parse_knn_response([{"url": u} for u in candidates])  # dedup across prompts


def download(
    urls: Sequence[str],
    out_dir: str,
    min_size: Optional[int] = None,
    http_get: Optional[Callable] = None,
    workers: int = 16,
) -> int:
    """Download candidates concurrently (`laion_clip_retrieval.py:96-137`
    uses a process pool; IO-bound fetches thread fine). Returns the
    number written."""
    get = http_get or _default_get
    os.makedirs(out_dir, exist_ok=True)

    def one(url: str) -> bool:
        try:
            if min_size is not None:
                head, _ = get(url, byte_range="bytes=0-2000000")
                if min(image_size_from_bytes(head)) < min_size:
                    return False
            content, headers = get(url)
            fname = filename_for(url, headers, content)
            with open(os.path.join(out_dir, fname), "wb") as fh:
                fh.write(content)
            return True
        except Exception:
            return False

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return sum(pool.map(one, urls))


def main(args=None):
    """CLI mirroring the reference flag surface
    (`laion_clip_retrieval.py:38-56`)."""
    import argparse

    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--out_dir", type=str, default="output/")
    parser.add_argument("--texts", type=str, default=[], nargs="*")
    parser.add_argument("--images", type=str, default=[], nargs="*")
    parser.add_argument("--urls", type=str, default=[], nargs="*")
    parser.add_argument("--modality", default="image", choices=["image", "text"])
    parser.add_argument("--number", type=int, default=40)
    parser.add_argument("--index", type=str, default="laion5B", choices=["laion5B", "laion_400m"])
    parser.add_argument("--multilingual", action="store_true")
    parser.add_argument("--no-deduplicate", action="store_true")
    parser.add_argument("--safety", action="store_true")
    parser.add_argument("--no-violence", action="store_true")
    parser.add_argument("--aesthetic-score", type=int, default=9)
    parser.add_argument("--aesthetic-weight", type=float, default=0.5)
    parser.add_argument("--size", type=int, default=None)
    args = parser.parse_args(args)

    candidates = retrieve(
        texts=args.texts, images=args.images, urls=args.urls,
        modality=args.modality, num_images=args.number, index=args.index,
        multilingual=args.multilingual, deduplicate=not args.no_deduplicate,
        safety=args.safety, violence_filter=not args.no_violence,
        aesthetic_score=args.aesthetic_score, aesthetic_weight=args.aesthetic_weight,
    )
    print(f"Found {len(candidates)} candidates.")
    num = download(candidates, args.out_dir, min_size=args.size)
    print(f"Downloaded {num} images.")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

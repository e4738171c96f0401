"""Remote Kandinsky / RuDALL-E API client.

Port of `maua_tpu/autoregressive/api.py`: the service's JSON request and the
decoding of its base64 PNG responses. The request itself needs network
egress and an en-ru translation checkpoint, so `request_kandinsky` raises,
as maua_tpu's does.
"""

from __future__ import annotations

import base64
from io import BytesIO
from typing import Iterator


def build_request_payload(text: str, top_k: int = 1500, top_p: float = 0.99, images_num: int = 4,
                          rerank_top: int = 4) -> dict:
    """The service's JSON schema."""
    return {"instances": [{"text": text, "top_k": top_k, "top_p": top_p, "images_num": images_num,
                           "rerank_top": rerank_top, "hi_res": True}]}


def decode_response(response_json: dict) -> Iterator:
    """PIL images from the service's base64 `images` list."""
    from PIL import Image

    for imgtext in response_json["images"]:
        yield Image.open(BytesIO(base64.b64decode(imgtext.encode("ascii"))))


def request_kandinsky(input_text: str, request_url: str, top_k: int = 1500, top_p: float = 0.99,
                      images_num: int = 4, rerank_top: int = 4, verbose: bool = False):
    """POST a translated prompt to the hosted endpoint: needs network egress and a Marian en-ru
    checkpoint, which this package does not provide."""
    raise RuntimeError(
        "request_kandinsky needs network egress (the hosted Kandinsky endpoint and the "
        "Helsinki-NLP/opus-mt-en-ru translation model); this environment has none. "
        "Use build_request_payload/decode_response with your own transport, or generate "
        "locally via maua_tpu_torch.autoregressive.oversample / .video."
    )

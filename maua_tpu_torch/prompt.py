"""Typed prompt containers passed into diffusion.

Port of `maua_tpu/prompt.py` (Prompt, TextPrompt, ImagePrompt,
StylePrompt, ContentPrompt). Images are numpy (1, H, W, C) float32 in
[-1, 1]. Fetching a URL and resizing to another size (lanczos) are not
ported and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .ops.io import load_image
from .utility import parse_prompt


class Prompt:
    def __init__(self, content=None, weight: float = 1.0):
        self.content = content
        self.weight = float(weight)


class TextPrompt(Prompt):
    def __init__(self, text: str, weight: float = 1.0):
        if ":" in text:
            text, weight = parse_prompt(text)
        super().__init__(text, weight)

    @property
    def text(self):
        return self.content


class ImagePrompt(Prompt):
    """A path, PIL image or array as a (1, H, W, C) float32 buffer in [-1, 1]."""

    def __init__(self, img=None, path: Optional[str] = None, url: Optional[str] = None,
                 size: Optional[Tuple[int, int]] = None, weight: float = 1.0):
        if url is not None:
            raise NotImplementedError("image prompts from a URL are not ported: load the file and pass path= or img=")
        if path is not None:
            if ":" in path:
                path, weight = parse_prompt(path)
            img = path
        arr = load_image(img) * 2.0 - 1.0
        if size is not None and tuple(size) != tuple(arr.shape[1:3]):
            raise NotImplementedError("resizing an image prompt (lanczos) is not ported yet")
        super().__init__(arr.astype(np.float32), weight)

    @property
    def img(self):
        return self.content


class StylePrompt(ImagePrompt):
    pass


class ContentPrompt(ImagePrompt):
    pass

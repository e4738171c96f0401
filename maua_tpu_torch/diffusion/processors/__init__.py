"""Diffusion processors: partial-denoise transforms over [-1, 1] images."""

from .base import BaseDiffusionProcessor  # noqa: F401

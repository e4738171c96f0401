"""Diffusion: the SD 1.x UNet and VAE, samplers, denoiser wrappers, processors and the image pipeline."""

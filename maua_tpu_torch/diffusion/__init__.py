"""Diffusion: the SD 1.x UNet and VAE, samplers, denoiser wrappers, processors, the image pipeline, the
animations (interpolation, KLMC2, outpainting, loops) and the flow-warped video."""

"""The diffusion networks: the UNet and the first-stage VAE."""

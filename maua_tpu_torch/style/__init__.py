"""Neural style transfer: images (Gatys optimization), multi-scale schedules and flow-consistent video."""

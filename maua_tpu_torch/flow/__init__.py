"""Optical flow: estimators (Farneback, Horn-Schunck), the consistency check, warp maps, flow files and
the cached preprocessing of a video."""

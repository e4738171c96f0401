"""Text encoders: the CLIP text tower and its tokenizers."""

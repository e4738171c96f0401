"""Text encoders: the CLIP text tower and BERT, with their tokenizers."""

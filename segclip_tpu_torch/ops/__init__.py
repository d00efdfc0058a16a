"""Tensor functions: normalisation, attention, grouping, position embeddings."""

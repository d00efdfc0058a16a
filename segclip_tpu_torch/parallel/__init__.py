"""Collectives of the port (segclip_tpu/parallel)."""

"""Collectives of the port (segclip_tpu/parallel) and the host → device
batch prefetch."""

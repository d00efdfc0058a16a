"""The training step (segclip_tpu/train)."""

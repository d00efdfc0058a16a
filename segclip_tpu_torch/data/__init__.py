"""Host-side data of the port: the CLIP tokenizer (segclip_tpu/data) and
the CLIP normalisation statistics."""

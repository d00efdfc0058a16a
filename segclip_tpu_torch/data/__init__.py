"""Host-side data of the port: the CLIP tokenizer and transforms, SGR
records, superpixels, the procedural shapes corpus and the training input
pipeline (copies of segclip_tpu/data, rgb transport)."""

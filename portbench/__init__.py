"""The benchmark of segclip_tpu_torch on one H100 (BENCHMARK.json at the root)."""

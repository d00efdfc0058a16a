"""The CLIP normalisation statistics of segclip_tpu/data/transforms.py
(in [0, 1] pixel space), copied so that the port imports nothing of the JAX
package; tests/test_torch_vendored.py holds them equal to the originals.
The image transforms themselves come with the data pipeline (slice 4)."""
from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

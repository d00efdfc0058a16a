"""A copy of the benchmark's files with every configuration cut to a size
the CPU runs in seconds (the widths too: these are tests, not cells), for
driving whole runs on the CPU with the kernels' plain versions."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TRAIN_CELL, EVAL_CELL = "train-b16-b256", "eval-l14-voc-f32"


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path, compute_dtype: str = "float32") -> Path:
    """tmp holding BENCHMARK.json and portbench/ with tiny configurations
    and traffic; the limits are the cells' own."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    small = dict(vision_width=128, vision_layers=3, first_stage_layer=2, group_num=4,
                 cross_layer=1, transformer_width=64, transformer_layers=1, embed_dim=32,
                 mae_decoder_depth=1, mae_decoder_num_heads=2)
    configs = tmp / "portbench" / "configs"
    _edit(configs / "segclip-vitb16.json", image_resolution=64, **small)
    _edit(configs / "segclip-vitl14.json", **dict(small, image_resolution=224,
                                                   vision_patch_size=16, vision_width=64,
                                                   vision_layers=2, first_stage_layer=1))
    traffic = tmp / "portbench" / "traffic"
    for name in ("pretrain-b256", "pretrain-b512-remat"):
        _edit(traffic / f"{name}.json", batch=8, reference_block=3, compute_dtype=compute_dtype,
              profiled_steps=2)
    _edit(traffic / "voc-val-slide-f32-x16.json", pool=4, landscape=3, images_per_device=2,
          checked_images=4, warm_calls=1, profile_after_calls=1, profiled_calls=1)
    return tmp


def args(workload: str, seed: int = 2 ** 31 + 17, seconds: float = 0.5, trace: int = 0):
    from portbench import run
    return run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])

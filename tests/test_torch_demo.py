"""The port's demo (segclip_tpu_torch/cli/demo.py) and its copy of
evalseg/visualize.py against the JAX package's, on the CPU.

The copy must write the same bytes as the original in every mode. Both
demos run on one exported segclip.bin-layout file at tiny widths in
float32, in single-image (slide) and dataset (whole) mode, with every
`--vis` mode: they must write the same files, the same label maps (the
`pred` PNGs, and the group maps through the group views), and the same
image bytes wherever the maps are equal.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from segclip_tpu.checkpoint.torch_export import export_state_dict
from segclip_tpu.cli import demo as jdemo
from segclip_tpu.config import ModelConfig
from segclip_tpu.evalseg import visualize as jvis
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

from segclip_tpu_torch.cli import demo as tdemo
from segclip_tpu_torch.evalseg import visualize as tvis

torch.set_num_threads(1)
TINY = ModelConfig(vision_width=64, vision_layers=4, first_stage_layer=3, group_num=4,
                   cross_layer=1, transformer_width=64, transformer_layers=2,
                   embed_dim=32, compute_dtype="float32")
OPTS = ["first_stage_layer=3", "group_num=4", "cross_layer=1", "compute_dtype=float32"]
VIS = list(tdemo.VIS_MODES)


@pytest.mark.parametrize("mode", VIS)
def test_visualize_copy_writes_the_same_bytes(tmp_path, mode):
    rng = np.random.default_rng(VIS.index(mode))
    image = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    pred = rng.integers(0, 21, (40, 56)).astype(np.int32)
    groups = [rng.integers(0, 8, (40, 56)).astype(np.int32) for _ in range(2)]
    palette = rng.integers(0, 256, (21, 3), dtype=np.uint8)
    names = [f"class{i}" for i in range(21)]
    written = []
    for side, mod in (("jax", jvis), ("port", tvis)):
        out = tmp_path / side / f"img.jpg"
        paths = mod.save_visualization(mode, str(out), image, pred, palette, names,
                                       True, group_maps=groups)
        written.append([os.path.relpath(p, tmp_path / side) for p in paths])
        assert paths
    assert written[0] == written[1]
    for rel in written[0]:
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes()
    np.testing.assert_array_equal(tvis.group_palette(9), jvis.group_palette(9))
    with pytest.raises(ValueError):
        tvis.save_visualization("nope", str(tmp_path / "x.jpg"), image, pred, palette,
                                names, True)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """An exported segclip.bin of seeded JAX weights, one JPEG and a
    3-image VOC layout of mixed sizes."""
    root = tmp_path_factory.mktemp("demo")
    _, params = jax_init_segclip(TINY, seed=2)
    sd = export_state_dict(jax.tree_util.tree_map(np.asarray, params),
                           vision_patch_size=TINY.vision_patch_size)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, root / "segclip.bin")
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, (180, 260, 3), dtype=np.uint8)).save(
        root / "photo.jpg")
    voc = root / "voc"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (voc / d).mkdir(parents=True)
    for i, (h, w) in enumerate(((200, 240), (230, 230), (150, 300))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            voc / "JPEGImages" / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 21, (h, w)).astype(np.uint8)).save(
            voc / "SegmentationClass" / f"img{i}.png")
    (voc / "ImageSets/Segmentation/val.txt").write_text("img0\nimg1\nimg2\n")
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f != "log.txt")


@pytest.mark.parametrize("source", ["single", "dataset"])
def test_demo_matches_jax(tmp_path, inputs, source):
    args = ["--init-model", str(inputs / "segclip.bin"), "--vis"] + VIS
    args += (["--input", str(inputs / "photo.jpg")] if source == "single" else
             ["--data-root", str(inputs / "voc"), "--first-n", "2"])
    jdemo.main(args + ["--output-dir", str(tmp_path / "jax"), "--opts"] + OPTS)
    tdemo.main(args + ["--device", "cpu", "--output-dir", str(tmp_path / "port"),
                       "--opts"] + OPTS)
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    stems = {os.path.splitext(os.path.basename(f))[0].split("_layer")[0] for f in files}
    assert stems == ({"photo"} if source == "single" else {"img0", "img1"})
    maps_equal = {}
    for f in files:
        if f.startswith("pred/"):
            a, b = (np.asarray(Image.open(tmp_path / side / f)) for side in ("jax", "port"))
            np.testing.assert_array_equal(b, a, err_msg=f)
            maps_equal[os.path.splitext(os.path.basename(f))[0]] = True
    for f in files:
        stem = os.path.splitext(os.path.basename(f))[0].split("_layer")[0]
        assert maps_equal[stem]
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


def test_demo_refuses_two_inputs_and_runs_on_the_card_unless_told(tmp_path, inputs):
    with pytest.raises(SystemExit):
        tdemo.main(["--input", "a.jpg", "--data-root", "d", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdemo.main(["--input", str(inputs / "photo.jpg"), "--output-dir",
                    str(tmp_path), "--opts"] + OPTS)

"""The port's studies (segclip_tpu_torch/studies) against the JAX package's
scripts on the CPU.

Each JAX script is loaded from scripts/ by file (unchanged) and its
`main()` called with sys.argv; the port's study runs with `--device cpu`.
Both read one reference-layout segclip.bin written from a seeded JAX init
(ViT at 224 with patch 32, width 64, 4 blocks split 3 + 1, the default 8
groups and 2 cross-attention blocks, text width 64 with 2 blocks, float32),
and one shapes corpus made by the port's `prepare_data shapes` (the same
bytes as the JAX one's), with a holdout pair_eval split.

Tolerances of the report comparison: both sides compute in float32 (the
JAX side on its default `attention_impl="xla"` route and its jnp grouping
on the CPU, the port on the kernels' plain versions), so a similarity or
an affinity differs by float32 rounding through a few blocks (~1e-6)
before both round to 4 decimals: within 2e-4. A pixel's prediction is an
argmax; on random weights a few pixels sit at near ties that rounding can
flip, so shares of pixels are held within 1e-3 and mIoU / mAcc / aAcc /
IoU within 0.5 points. Counts (images, pixels, presence) are exact.

The port fixes two faults of the scripts (ADVICE r5): its AUC ranks ties
at their midrank, and the best other channel of the margin probe is chosen
by index. The tests here show each fix where ties occur, and show that
without ties the two agree.
"""
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax

from segclip_tpu.checkpoint.torch_export import export_state_dict
from segclip_tpu.config import ModelConfig
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

from segclip_tpu_torch.cli import prepare_data
from segclip_tpu_torch.studies import (classprobe, eval_ipd_study, holdout_study,
                                       spatial_margin_probe)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The studies' starting configuration (STUDY_MODEL) at tiny widths; the
# group count and cross depth stay at their defaults, because the JAX
# eval_ipd_study takes no overrides and its load_model keeps the caller's.
TINY = ModelConfig(image_resolution=224, vision_patch_size=32, vision_width=64,
                   vision_layers=4, first_stage_layer=3, transformer_width=64,
                   transformer_layers=2, embed_dim=32, compute_dtype="float32",
                   use_vision_mae_recon=True, use_seglabel=True, gumbel_tau=3.0,
                   group_balance_weight=1.0)
F32 = ["--opts", "compute_dtype=float32"]
EVAL_N = 6
PAIR_N = 12
SIM_TOL, SHARE_TOL, POINTS_TOL = 2e-4, 1e-3, 0.5


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(segclip.bin, corpus dir): a seeded tiny model, and a shapes corpus
    with an EVAL_N-image eval split and a holdout pair_eval split of one
    image per color × shape pair, cut to PAIR_N of its 48 images: every
    held-out pair's and as many seen ones."""
    root = tmp_path_factory.mktemp("studies")
    _, params = jax_init_segclip(TINY, seed=3)
    sd = export_state_dict(jax.tree_util.tree_map(np.asarray, params),
                           vision_patch_size=TINY.vision_patch_size)
    ckpt = str(root / "segclip.bin")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, ckpt)
    corpus = str(root / "corpus")
    prepare_data.main(["shapes", "--out-dir", corpus, "--train-n", "8", "--eval-n",
                       str(EVAL_N), "--holdout", "--pair-eval-n", "1",
                       "--no-superpixels"])
    with open(os.path.join(corpus, "holdout.json")) as f:
        holdout = {tuple(p) for p in json.load(f)["holdout_pairs"]}
    with open(os.path.join(corpus, "pair_eval", "pairs.json")) as f:
        pairs = json.load(f)
    split = os.path.join(corpus, "pair_eval", "ImageSets", "Segmentation", "val.txt")
    with open(split) as f:
        names = f.read().split()
    held = [n for n in names if (pairs[n]["color"], pairs[n]["shape"]) in holdout]
    seen = [n for n in names if n not in held][:PAIR_N - len(held)]
    with open(split, "w") as f:
        f.write("".join(f"{n}\n" for n in names if n in held + seen))
    return ckpt, corpus


def run_jax_script(name, argv, monkeypatch, capsys) -> dict:
    """scripts/<name>.py's main() under `argv`, on the JAX set-up of
    tests/conftest.py (its setup_jax would move the compilation cache);
    the report it printed last."""
    from segclip_tpu.utils import jax_setup
    module = _jax_module(name)
    monkeypatch.setattr(jax_setup, "setup_jax", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    module.main()
    return last_report(capsys.readouterr().out)


def last_report(text: str) -> dict:
    lines = text.splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


def close(got, want, tol, what):
    if want is None or got is None:
        assert got is want, what
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), what
    else:
        assert got == pytest.approx(want, abs=tol), what


def test_classprobe_matches_the_jax_script(inputs, monkeypatch, capsys, tmp_path):
    ckpt, corpus = inputs
    argv = ["--ckpt", ckpt, "--data-root", corpus, "--batch", "4"] + F32
    want = run_jax_script("classprobe", argv, monkeypatch, capsys)
    out = tmp_path / "port.json"
    got = classprobe.main(argv + ["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert got.keys() == want.keys() and got["n_images"] == want["n_images"] == EVAL_N
    assert got["per_class"].keys() == want["per_class"].keys()
    for name, w in want["per_class"].items():
        g = got["per_class"][name]
        assert g.keys() == w.keys() and g["n_present"] == w["n_present"], name
        for key in ("mean_sim_present", "mean_sim_absent"):
            close(g[key], w[key], SIM_TOL, (name, key))
        # random-weight sims of different images are far apart against
        # float32 rounding, so no rank moves and no score ties: the midrank
        # AUC equals the script's exactly
        close(g["auc"], w["auc"], 0.0, (name, "auc"))


def test_spatial_margin_probe_matches_the_jax_script(inputs, monkeypatch, capsys):
    ckpt, corpus = inputs
    argv = ["--ckpt", ckpt, "--data-root", os.path.join(corpus, "eval"),
            "--limit", "4"] + F32
    want = run_jax_script("spatial_margin_probe", argv, monkeypatch, capsys)
    got = spatial_margin_probe.main(argv + ["--device", "cpu"])
    assert got.keys() == want.keys() and got["bg_thresh"] == want["bg_thresh"]
    assert got["per_class"].keys() == want["per_class"].keys() and want["per_class"]
    for name, w in want["per_class"].items():
        g = got["per_class"][name]
        assert g.keys() == w.keys() and g["gt_pixels"] == w["gt_pixels"], name
        for key in ("fg_argmax_is_own", "pred_background", "pred_own", "pred_other_fg"):
            close(g[key], w[key], SHARE_TOL, (name, key))
        for key in ("mean_own_aff", "mean_best_other_fg_aff"):
            close(g[key], w[key], SIM_TOL, (name, key))


def test_holdout_study_matches_the_jax_script(inputs, monkeypatch, capsys):
    ckpt, corpus = inputs
    argv = ["--ckpt", ckpt, "--data-root", corpus] + F32
    want = run_jax_script("holdout_study", argv, monkeypatch, capsys)
    got = holdout_study.main(argv + ["--device", "cpu"])
    got = json.loads(json.dumps(got))                       # tuples → lists
    assert got.keys() == want.keys()
    assert got["holdout_pairs"] == want["holdout_pairs"] and want["holdout_pairs"]
    for bank in ("standard_bank", "composed_bank"):
        assert got[bank].keys() == want[bank].keys() == {"held_out", "seen"}
        for split, w in want[bank].items():
            g = got[bank][split]
            assert g.keys() == w.keys()
            for key in ("mIoU", "mAcc"):
                close(g[key], w[key], POINTS_TOL, (bank, split, key))
            for name, iou in (w.get("per_class") or {}).items():
                close(g["per_class"][name], iou, POINTS_TOL, (bank, split, name))
    pairs = want["composed_per_pair_iou"]
    assert got["composed_per_pair_iou"].keys() == pairs.keys() and len(pairs) == PAIR_N
    for name, iou in pairs.items():
        close(got["composed_per_pair_iou"][name], iou, POINTS_TOL, name)


def test_eval_ipd_study_matches_the_jax_script(inputs, monkeypatch, capsys):
    """At --ipd 2 on a one-device mesh: the JAX script batches per device
    (`n_images = ipd`, a single-device study), the simulated CPU mesh of
    tests/conftest.py has eight."""
    from segclip_tpu.parallel import mesh
    ckpt, corpus = inputs
    make_mesh = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh", lambda: make_mesh(1))
    argv = ["--ckpt", ckpt, "--data-root", os.path.join(corpus, "eval"), "--ipd", "2",
            "--limit", "4", "--dtype", "float32"]
    want = run_jax_script("eval_ipd_study", argv, monkeypatch, capsys)
    got = eval_ipd_study.main(argv + ["--device", "cpu"])
    assert got.keys() == want.keys() and got["n_images"] == want["n_images"] == 4
    for path in ("seq", "ipd2"):
        assert got[path].keys() == want[path].keys()
        for key in ("mIoU", "mAcc", "aAcc"):
            close(got[path][key], want[path][key], POINTS_TOL, (path, key))
        assert got[path]["img_s"] > 0
    close(got["d_miou"], want["d_miou"], POINTS_TOL, "d_miou")
    close(got["flipped_pixel_frac"], want["flipped_pixel_frac"], SHARE_TOL, "flips")


def test_midrank_auc_equals_the_script_without_ties():
    jax_classprobe = _jax_module("classprobe")
    rng = np.random.default_rng(0)
    scores = rng.normal(size=40)
    labels = rng.random(40) < 0.4
    assert classprobe.auc(scores, labels) == pytest.approx(
        jax_classprobe.auc(scores, labels), abs=1e-12)


def test_midrank_auc_is_mann_whitney_under_ties():
    from scipy.stats import mannwhitneyu
    jax_classprobe = _jax_module("classprobe")
    scores = np.array([0.5, 0.5, 0.5, 0.5, 0.2, 0.9, 0.2, 0.5])
    labels = np.array([True, True, False, False, False, True, True, False])
    pos, neg = scores[labels], scores[~labels]
    want = mannwhitneyu(pos, neg).statistic / (len(pos) * len(neg))
    assert classprobe.auc(scores, labels) == pytest.approx(want, abs=1e-12)
    assert jax_classprobe.auc(scores, labels) != pytest.approx(want, abs=1e-3)
    np.testing.assert_array_equal(classprobe.midranks(np.array([3.0, 1.0, 3.0, 2.0])),
                                  [3.5, 1.0, 3.5, 2.0])


def test_best_other_channel_is_chosen_by_index():
    """Class 1's own channel (index 0) within np.isclose of channel 1, which
    is the argmax: the best other channel is the argmax (top-1); the
    script's value rule takes the own channel for the argmax and reports
    top-2, the own affinity."""
    fg = np.array([[0.3, 0.3000001, 0.1],        # near tie, another channel wins
                   [0.6, 0.2, 0.1],              # own channel wins clearly
                   [0.1, 0.5, 0.2]], np.float32)  # another channel wins clearly
    own, top = fg[:, 0], np.sort(fg, axis=-1)
    script = np.where(np.isclose(own, top[:, -1]), top[:, -2], top[:, -1])
    got = spatial_margin_probe.best_other(fg, 1)
    np.testing.assert_array_equal(got, [fg[0, 1], fg[1, 1], fg[2, 1]])
    np.testing.assert_array_equal(script, [fg[0, 0], fg[1, 1], fg[2, 1]])


@pytest.mark.parametrize("shape", [(224, 261, 250, 300), (288, 240, 224, 224),
                                   (224, 224, 448, 112), (17, 9, 5, 31)],
                         ids=["up", "down", "mixed", "odd"])
def test_resize_equals_cv2_inter_linear(shape):
    cv2 = pytest.importorskip("cv2")
    h, w, oh, ow = shape
    x = np.random.default_rng(h * w).normal(size=(7, h, w)).astype(np.float32) * 4
    want = cv2.resize(x.transpose(1, 2, 0), (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = spatial_margin_probe.resize_linear(torch.from_numpy(x), oh, ow)
    assert tuple(got.shape) == (7, oh, ow)
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, rtol=0, atol=1e-5)


def test_center_crop_pads_a_short_side():
    img = np.arange(230 * 200 * 3, dtype=np.float32).reshape(230, 200, 3)
    out = classprobe.center_crop(img, 224)
    assert out.shape == (224, 224, 3)
    np.testing.assert_array_equal(out[:, :200], img[3:227])
    assert not out[:, 200:].any()


@pytest.mark.parametrize("study", [classprobe, spatial_margin_probe, holdout_study,
                                   eval_ipd_study],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_study_runs_on_the_card_unless_told(study, tmp_path):
    """With no --device a study asks for the card; without one it raises
    before it reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        study.main(["--ckpt", str(tmp_path / "none.bin"), "--data-root", str(tmp_path)])


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

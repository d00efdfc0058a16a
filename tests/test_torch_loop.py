"""The port's training loop, train CLI and checkpoints
(segclip_tpu_torch/{train/loop,cli/train,checkpoint/io,parallel/prefetch})
on the CPU, at the tiny widths of tests/test_cli_e2e.py, `--device cpu`.

The loop is held to the JAX package's loop: the batches it hands the step,
in order (each package's step factory is patched inside the test to record
them), the checkpoint cadence, and the logged learning rates (the JAX
`scheduled_lr`, to 1e-6 relative). Resume is held to a straight run bit for
bit: the step's noise is a function of (seed, step) only, and the CPU's
sums run in a fixed order.
"""
import ast
import dataclasses
import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from segclip_tpu import config as jconfig
from segclip_tpu.train import loop as jloop
from segclip_tpu.train.optimizer import scheduled_lr

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.checkpoint import io as ckpt_io
from segclip_tpu_torch.checkpoint.convert import load_into, load_reference_state_dict
from segclip_tpu_torch.cli import eval_zeroshot, prepare_data
from segclip_tpu_torch.cli import train as train_cli
from segclip_tpu_torch.data.pipeline import SyntheticDataset
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip
from segclip_tpu_torch.parallel.prefetch import prefetch_to_device, to_device
from segclip_tpu_torch.train import loop as tloop
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
from segclip_tpu_torch.utils.device import resolve_device
from segclip_tpu_torch.utils.logging import get_logger

torch.set_num_threads(2)

TINY_OPTS = [
    "model.vision_width=64", "model.vision_layers=4",
    "model.first_stage_layer=3", "model.group_num=4", "model.cross_layer=1",
    "model.transformer_width=64", "model.transformer_layers=2",
    "model.embed_dim=32", "model.mae_decoder_depth=1",
    "model.mae_decoder_num_heads=2", "model.compute_dtype=float32",
]
TINY_EVAL_OPTS = [o.split("model.", 1)[1] for o in TINY_OPTS]
LR_RTOL = 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 shapes scenes (32 samples, captions "both") and a 2-image eval split."""
    root = tmp_path_factory.mktemp("shapes")
    prepare_data.main(["shapes", "--out-dir", str(root), "--train-n", "16",
                       "--eval-n", "2"])
    return str(root)


def tiny_config(corpus, out, **train_kw):
    cfg = tconfig.apply_overrides(tconfig.Config(), TINY_OPTS + [
        "data.datatype=shapes", f"data.data_dir={corpus}", "data.batch_size=8",
        "data.transfer=rgb", "train.log_every=1", "train.eval_each_epoch=false",
        f"train.output_dir={out}"])
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))


def read_metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_synthetic_writes_log_metrics_checkpoint_and_trace(tmp_path):
    out, trace = tmp_path / "run", tmp_path / "trace"
    result = train_cli.main([
        "--device", "cpu", "--datatype", "synthetic", "--batch-size", "256",
        "--epochs", "1", "--max-words", "12", "--n-display", "1",
        "--output-dir", str(out), "--profile", str(trace), "--opts"] + TINY_OPTS +
        ["train.eval_each_epoch=false"])
    assert (out / "log.txt").exists()
    metrics = read_metrics(out)
    assert len(metrics) == 2                      # 512 synthetic / 256 = 2
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert sorted(os.listdir(out / "ckpt_epoch_0")) == ["model.pt", "train_state.pt"]
    assert result["epochs_run"] == 1 and result["state"].step == 2
    [name] = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    names = {e.get("name") for e in json.loads((trace / name).read_text())["traceEvents"]}
    assert {"train.step", "train.forward", "train.optimizer"} <= names


def test_train_cli_preset_keeps_best_and_explicit_flags_win(tmp_path, corpus):
    """--preset shapes-learnability: the preset's values land (on the JAX
    CLI's default transport, yuv420), explicit
    flags and --opts win over them, and the run trains, evaluates after
    each epoch on <data-dir>/eval, goes on training after the eval, and
    keeps the best."""
    out = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--preset", "shapes-learnability",
                    "--data-dir", corpus, "--output-dir", str(out),
                    "--batch-size", "8", "--epochs", "2", "--n-display", "1",
                    "--opts"] + TINY_OPTS + ["model.gumbel_tau=2.0"])
    cfg_line = next(line for line in (out / "log.txt").read_text().splitlines()
                    if "config: " in line)
    cfg = ast.literal_eval(cfg_line.split("config: ", 1)[1])
    assert cfg["optim"]["lr"] == cfg["optim"]["lower_lr"] == 4e-4
    assert cfg["optim"]["warmup_proportion"] == 0.1
    assert cfg["model"]["group_balance_weight"] == 1.0
    assert cfg["model"]["use_seglabel"] and cfg["model"]["use_vision_mae_recon"]
    assert cfg["train"]["keep_best"] and cfg["train"]["eval_each_epoch"]
    assert cfg["eval"]["dataset"] == "shapes" and cfg["data"]["transfer"] == "yuv420"
    assert cfg["data"]["batch_size"] == 8 and cfg["train"]["epochs"] == 2
    assert cfg["model"]["gumbel_tau"] == 2.0
    metrics = read_metrics(out)
    losses = [m for m in metrics if "loss" in m]
    mious = [m for m in metrics if "miou" in m]
    assert len(losses) == 8 and all(np.isfinite(m["loss"]) for m in losses)
    assert [m["epoch"] for m in mious] == [0, 1]
    assert all(0.0 <= m["miou"] <= 100.0 for m in mious)
    best = json.loads((out / "best.json").read_text())
    assert best["miou"] == max(m["miou"] for m in mious)
    for name in ("ckpt_best", "ckpt_epoch_0", "ckpt_epoch_1"):
        assert (out / name / "model.pt").exists(), name


def test_loop_hands_the_step_the_jax_batches_and_checkpoints_alike(tmp_path, corpus):
    """Both loops over the same corpus for 3 epochs with checkpoint_every=2:
    the same batches in the same order, and checkpoints after epochs 1 and
    2 (the cadence, and the last epoch always). The port widens int32
    fields to int64 on the transfer."""
    tcfg = tiny_config(corpus, str(tmp_path / "t"), epochs=3, checkpoint_every=2, seed=5)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, infonce_mask="class", image_resolution=32, vision_patch_size=8))
    jcfg = jconfig.apply_overrides(jconfig.Config(**{
        f.name: getattr(jconfig, type(sub).__name__)(**dataclasses.asdict(sub))
        for f in dataclasses.fields(tcfg) for sub in [getattr(tcfg, f.name)]}),
        [f"train.output_dir={tmp_path / 'j'}", "data.packed_transfer=false"])
    seen = {"jax": [], "port": []}

    def jax_factory(mesh, model, tx, **kw):
        def step(state, batch):
            seen["jax"].append({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss": jnp.float32(1.0)}
        return step

    def port_factory(model, optimizer, cfg):
        def step(state, batch, noise=None):
            seen["port"].append({k: v.numpy() for k, v in batch.items()})
            state.step += 1
            return {"loss": torch.tensor(1.0)}
        return step

    with mock.patch.object(jloop, "make_sharded_train_step", jax_factory):
        jloop.train(jcfg)
    with mock.patch.object(tloop, "make_train_step", port_factory):
        tloop.train(tcfg, device="cpu")
    ref, out = seen["jax"], seen["port"]
    assert len(out) == len(ref) == 3 * 4
    for a, b in zip(ref, out):
        assert sorted(b) == sorted(a) and "text_class" in a
        for key in a:
            want = np.int64 if a[key].dtype == np.int32 else a[key].dtype
            assert b[key].dtype == want, key
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    ckpts = [sorted(d for d in os.listdir(tmp_path / side) if d.startswith("ckpt"))
             for side in ("j", "t")]
    assert ckpts[0] == ckpts[1] == ["ckpt_epoch_1", "ckpt_epoch_2"]


@pytest.fixture(scope="module")
def straight(tmp_path_factory, corpus):
    """Two epochs straight (4 steps each), checkpoint after each."""
    out = str(tmp_path_factory.mktemp("straight"))
    cfg = tiny_config(corpus, out, epochs=2)
    return cfg, tloop.train(cfg, device="cpu"), out


def test_logged_lrs_match_the_jax_schedule(straight):
    cfg, _, out = straight
    lrs = [(m["step"], m["lr"]) for m in read_metrics(out)]
    assert [s for s, _ in lrs] == list(range(1, 9))
    o = cfg.optim
    for step, lr in lrs:
        want = float(scheduled_lr(jnp.int32(step), o.lr, 8, o.warmup_proportion,
                                  o.schedule, o.lr_start, o.lr_end))
        assert lr == pytest.approx(want, rel=LR_RTOL, abs=1e-12), step


def test_resume_is_bit_identical_to_a_straight_run(tmp_path, straight):
    """1 epoch, save, resume, 1 epoch == 2 epochs straight: the last loss,
    every parameter, every moment and both step counters."""
    cfg, result, out = straight
    shutil.copytree(os.path.join(out, "ckpt_epoch_0"), tmp_path / "ckpt_epoch_0")
    resumed = tloop.train(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, output_dir=str(tmp_path))),
        resume=True, device="cpu")
    assert resumed["epochs_run"] == 1
    assert [m["epoch"] for m in read_metrics(tmp_path)] == [1] * 4
    assert resumed["final_loss"] == result["final_loss"]
    assert read_metrics(tmp_path)[-1] == {**read_metrics(out)[-1],
                                          "time": read_metrics(tmp_path)[-1]["time"]}
    for name in ("model.pt", "train_state.pt"):
        a = torch.load(os.path.join(out, "ckpt_epoch_1", name), weights_only=True)
        b = torch.load(tmp_path / "ckpt_epoch_1" / name, weights_only=True)
        if name == "model.pt":
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert {k: a[k] for k in a if k != "optimizer"} == \
                {k: b[k] for k in b if k != "optimizer"}
            sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
            assert sa.keys() == sb.keys() and all(
                torch.equal(sa[i][m], sb[i][m]) for i in sa for m in sa[i])
    assert resumed["optimizer"].step_count == result["optimizer"].step_count == 8
    assert resumed["state"].step == result["state"].step == 8


def test_epochs_per_run_segments_equal_a_straight_run(tmp_path, corpus):
    """train.epochs_per_run=1 on the default transport (yuv420): a first run
    trains epoch 0 and stops, a resumed one trains epoch 1, and together
    they equal two epochs straight bit for bit (losses, checkpoints,
    schedule). keep_best's best carries across the segments through
    best.json: the eval scores 60 then 40, so epoch 0 stays the best."""
    def scripted_eval():
        scores = iter([60.0, 40.0])
        return lambda model: next(scores)

    def config(out, **kw):
        cfg = tiny_config(corpus, str(out), epochs=2, keep_best=True,
                          eval_each_epoch=True, **kw)
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, transfer="yuv420"))

    straight = tloop.train(config(tmp_path / "straight"), eval_fn=scripted_eval(),
                           device="cpu")
    seg_eval = scripted_eval()
    runs = [tloop.train(config(tmp_path / "seg", epochs_per_run=1), resume=True,
                        eval_fn=seg_eval, device="cpu") for _ in range(2)]
    assert [r["epochs_run"] for r in runs] == [1, 1]
    assert [r["state"].step for r in runs] == [4, 8] and straight["state"].step == 8
    assert runs[1]["final_loss"] == straight["final_loss"]
    strip = [[{k: v for k, v in m.items() if k != "time"} for m in read_metrics(tmp_path / d)]
             for d in ("straight", "seg")]
    assert strip[0] == strip[1] and [m["epoch"] for m in strip[1]] == [0] * 5 + [1] * 5
    for d in ("straight", "seg"):
        assert json.loads((tmp_path / d / "best.json").read_text()) == {"miou": 60.0,
                                                                        "epoch": 0}
    for ckpt in ("ckpt_epoch_0", "ckpt_epoch_1", "ckpt_best"):
        for name in ("model.pt", "train_state.pt"):
            a = torch.load(tmp_path / "straight" / ckpt / name, weights_only=True)
            b = torch.load(tmp_path / "seg" / ckpt / name, weights_only=True)
            if name == "model.pt":
                assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
            else:
                assert {k: a[k] for k in a if k != "optimizer"} == \
                    {k: b[k] for k in b if k != "optimizer"}, ckpt
                sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
                assert sa.keys() == sb.keys() and all(
                    torch.equal(sa[i][m], sb[i][m]) for i in sa for m in sa[i])


def test_a_failed_eval_is_logged_and_training_goes_on(tmp_path, corpus):
    def broken_eval(model):
        raise RuntimeError("no eval data")

    cfg = tiny_config(corpus, str(tmp_path), epochs=2, keep_best=True,
                      eval_each_epoch=True)
    result = tloop.train(cfg, eval_fn=broken_eval, device="cpu")
    assert result["state"].step == 8 and np.isfinite(result["final_loss"])
    assert (tmp_path / "log.txt").read_text().count("per-epoch eval failed") == 2
    assert not any("miou" in m for m in read_metrics(tmp_path))
    assert not (tmp_path / "ckpt_best").exists() and not (tmp_path / "best.json").exists()


def test_checkpoint_gc_auto_resume_and_best(tmp_path):
    """max_kept removes the oldest ckpt_epoch_* only, ckpt_best is outside
    that namespace, auto_resume_path picks the latest epoch, and a restore
    brings back the moments in the optimizer's moment dtype."""
    mcfg = _tiny_model_config()
    cfg = dataclasses.replace(tconfig.Config(model=mcfg), optim=tconfig.OptimConfig(
        moment_dtype="bfloat16"))
    model = init_segclip(mcfg, seed=4)
    optimizer = create_optimizer(model, cfg, t_total=10)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    assert ckpt_io.auto_resume_path(str(tmp_path)) is None
    for epoch in range(4):
        ckpt_io.save_checkpoint(str(tmp_path), epoch, model, optimizer,
                           TrainState(step=epoch + 1, seed=9), max_kept=2)
    ckpt_io.save_checkpoint(str(tmp_path), 1, model, optimizer, TrainState(step=2, seed=9),
                       max_kept=2, name="ckpt_best")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_best", "ckpt_epoch_2", "ckpt_epoch_3"]
    assert ckpt_io.auto_resume_path(str(tmp_path)) == str(tmp_path / "ckpt_epoch_3")

    fresh = init_segclip(mcfg, seed=5)
    fresh_opt = create_optimizer(fresh, cfg, t_total=10)
    state, epoch = ckpt_io.restore_checkpoint(str(tmp_path / "ckpt_best"), fresh, fresh_opt,
                                         TrainState())
    assert (state.step, state.seed, epoch, fresh_opt.step_count) == (2, 9, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), model.parameters()))
    for p in (q for group in fresh_opt.param_groups for q in group["params"]):
        moments = fresh_opt.state[p]
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.bfloat16


def test_init_model_starts_the_loop_from_a_checkpoint(tmp_path, straight):
    """--init-model: the loop's model starts from a model.pt (and trains
    from a fresh optimizer)."""
    cfg, _, out = straight
    model_pt = os.path.join(out, "ckpt_epoch_0", "model.pt")
    seen = {}

    def factory(model, optimizer, cfg):
        seen["start"] = {k: v.clone() for k, v in model.state_dict().items()}
        seen["step_count"] = optimizer.step_count
        return make_train_step(model, optimizer, cfg)

    with mock.patch.object(tloop, "make_train_step", factory):
        tloop.train(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, output_dir=str(tmp_path), epochs=1)),
            init_model=model_pt, device="cpu")
    want = load_reference_state_dict(model_pt)
    assert seen["step_count"] == 0 and seen["start"].keys() == want.keys()
    assert all(torch.equal(seen["start"][k], want[k]) for k in want)


def _voc(root, n=2):
    rng = np.random.default_rng(3)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (root / d).mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (72, 96, 3)).astype(np.uint8)).save(
            root / "JPEGImages" / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 21, (72, 96)).astype(np.uint8)).save(
            root / "SegmentationClass" / f"img{i}.png")
    (root / "ImageSets/Segmentation/val.txt").write_text(
        "\n".join(f"img{i}" for i in range(n)) + "\n")
    return root


def test_checkpoint_model_pt_loads_through_the_eval_cli(tmp_path, straight, capsys):
    _, result, out = straight
    model_pt = os.path.join(out, "ckpt_epoch_1", "model.pt")
    sd = load_reference_state_dict(model_pt)
    model = SegCLIP(result["model"].cfg)
    assert load_into(model, sd) == []
    assert all(torch.equal(v, result["model"].state_dict()[k]) for k, v in sd.items())
    results = eval_zeroshot.main([
        "--device", "cpu", "--dataset", "voc", "--data-root", str(_voc(tmp_path / "voc")),
        "--init-model", model_pt, "--output-dir", str(tmp_path / "eval"),
        "--opts"] + TINY_EVAL_OPTS)
    assert 0.0 <= results["mIoU"] <= 100.0
    capsys.readouterr()


def _tiny_model_config(**kw):
    base = tconfig.apply_overrides(tconfig.Config(), TINY_OPTS + [
        "model.image_resolution=32", "model.vision_patch_size=8",
        "model.max_words=16"]).model
    return dataclasses.replace(base, **kw)


def test_int32_batches_run_through_the_step():
    """The pipeline's int32 fields (ids, mask, superpixels, class metadata)
    give the step the same metrics as their int64 widening by to_device."""
    mcfg = _tiny_model_config(infonce_mask="class", use_text_mae_recon=True)
    cfg = tconfig.Config(model=mcfg)
    ds = SyntheticDataset(length=4, max_words=16, image_size=32, patch_size=8,
                          vocab_size=mcfg.vocab_size, normalize=False, emit_class_ids=True)
    samples = [ds.sample(i, np.random.default_rng(i)) for i in range(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    assert {k for k, v in batch.items() if v.dtype == np.int32} == {
        "input_ids", "attention_mask", "image_seg", "text_class", "scene_classes"}
    widened, pinned = to_device(batch, torch.device("cpu"))
    assert pinned == [] and all(v.dtype != torch.int32 for v in widened.values())
    runs = []
    for b in ({k: torch.from_numpy(v) for k, v in batch.items()}, widened):
        model = init_segclip(mcfg, seed=1)
        step = make_train_step(model, create_optimizer(model, cfg, t_total=4), cfg)
        runs.append(step(TrainState(seed=3), b))
    assert np.isfinite(float(runs[0]["loss"])) and runs[0]["skipped_nan"] == 0
    assert runs[0].keys() == runs[1].keys()
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    got = list(prefetch_to_device(iter([batch, batch]), torch.device("cpu"), depth=1))
    assert len(got) == 2 and all(torch.equal(got[1][k], widened[k]) for k in widened)


def test_eval_under_compute_dtype_shares_the_training_parameters(tmp_path):
    """eval.compute_dtype=float32 on a bfloat16 training model: the eval
    runs a float32 model over the training model's own parameters, so it
    sees every in-place update (as a fresh float32 copy does)."""
    mcfg = _tiny_model_config(compute_dtype="bfloat16")
    cfg = dataclasses.replace(tconfig.Config(model=mcfg), eval=tconfig.EvalConfig(
        dataset="voc", compute_dtype="float32"))
    eval_fn = train_cli.make_eval_fn(cfg, str(_voc(tmp_path / "voc")), get_logger())
    model = init_segclip(mcfg, seed=2)
    spec = eval_zeroshot.DATASET_SPECS["voc"]

    def fresh_float32():
        m32 = dataclasses.replace(mcfg, compute_dtype="float32")
        copy = SegCLIP(m32)
        copy.load_state_dict(model.state_dict())
        seg = eval_zeroshot.build_segmenter(copy.eval(), m32, spec)
        return eval_zeroshot.evaluate_dataset(
            seg, eval_zeroshot.SegEvalDataset(spec, str(tmp_path / "voc")))["mIoU"]

    before = [p.requires_grad for p in model.parameters()], model.training
    assert eval_fn(model) == fresh_float32()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    assert eval_fn(model) == fresh_float32()
    assert ([p.requires_grad for p in model.parameters()], model.training) == before


@pytest.mark.parametrize("extra, match", [
    (["--opts", "train.tensor_parallelism=2"], r"must divide the world size \(1\)"),
    (["--opts", "train.data_parallelism=2"], "world size, 1"),
    (["--dist-coordinator", "localhost:1234"], "--dist-num-processes")],
    ids=["tp", "dp", "dist"])
def test_unported_settings_raise_naming_the_roadmap(tmp_path, extra, match):
    """A tensor parallelism that does not divide the world size, a data
    parallelism other than world // tensor parallelism, and an incomplete
    --dist-* triple are refused before any step or rendezvous."""
    with pytest.raises(ValueError, match=match):
        train_cli.main(["--device", "cpu", "--datatype", "synthetic", "--batch-size", "4",
                        "--epochs", "1", "--output-dir", str(tmp_path)] + extra)
    assert not (tmp_path / "ckpt_epoch_0").exists()


def test_per_epoch_eval_takes_the_sharded_evaluator(tmp_path):
    """eval.images_per_device > 1 in a world of one process: the per-epoch
    eval decodes several images per call, with the sequential metrics at
    float32."""
    from segclip_tpu_torch.evalseg import inference
    mcfg = _tiny_model_config(compute_dtype="float32")
    voc = str(_voc(tmp_path / "voc", n=3))
    model = init_segclip(mcfg, seed=2)
    results = {}
    for per_call in (1, 2):
        cfg = dataclasses.replace(tconfig.Config(model=mcfg), eval=tconfig.EvalConfig(
            dataset="voc", images_per_device=per_call))
        with mock.patch.object(inference.ZeroShotSegmenter, "predict_batch",
                               autospec=True,
                               side_effect=inference.ZeroShotSegmenter.predict_batch) as spy:
            results[per_call] = train_cli.make_eval_fn(cfg, voc, get_logger())(model)
        assert [len(c.args[1]) for c in spy.call_args_list] == ([] if per_call == 1
                                                                else [2, 1])
    assert results[1] == results[2]


def test_train_cli_runs_on_the_card_unless_the_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py trains on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--datatype", "synthetic", "--batch-size", "4", "--epochs", "1",
                        "--output-dir", str(tmp_path), "--opts"] + TINY_OPTS)

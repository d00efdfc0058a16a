"""Data parallelism in the port across 2 processes on the CPU (gloo, a
file:// rendezvous under the test's temporary directory), against the JAX
package on its simulated mesh.

Each test starts its ranks as child processes of this file
(`python tests/test_torch_parallel.py <scenario> <rank> <world> <rendezvous>
<workdir>`) or of the train CLI, each under a time limit of 60 s; the
children import torch and the port only (they check that no module of
segclip_tpu, jax or flax was loaded), and the test process computes the JAX
side. So this module imports JAX inside the tests, never at its top.

  - InfoNCE sharded across 2 ranks equals the global InfoNCE of JAX, in
    value (rtol 1e-5) and gradient (rtol 2e-4, atol 1e-6, the tolerances of
    tests/test_parallel.py), with and without the class mask: the gather's
    backward sums every rank's cotangent;
  - three training steps at 2 ranks equal `make_sharded_train_step` over a
    2-device JAX mesh, each shard's noise injected (the patched JAX draws
    pick their rows by `jax.lax.axis_index`): losses rtol 1e-5, every
    parameter within 1e-5; the ranks' replicas bit-identical; the second
    step's NaN half-batch skipped by both ranks;
  - the loop's per-rank batches are the JAX pipeline's for that shard, bit
    for bit, and in rank order they are the 1-rank batch's samples;
  - the train CLI at 2 ranks: only rank 0 writes, and a resume reproduces
    the straight run bit for bit;
  - remat (ModelConfig.remat) at 2 ranks with two micro-batches per rank
    and a NaN step changes no metric and no parameter, bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 60
WORLD = 2
TINY_KW = dict(image_resolution=32, vision_patch_size=8, vision_width=64,
               vision_layers=4, first_stage_layer=3, group_num=4, cross_layer=1,
               context_length=16, vocab_size=512, transformer_width=64,
               transformer_layers=2, embed_dim=32, max_words=12,
               use_vision_mae_recon=True, use_text_mae_recon=False, use_seglabel=True,
               mae_decoder_depth=1, mae_decoder_num_heads=2, compute_dtype="float32",
               grouping_impl="jnp")
TINY_OPTS = [f"model.{k}={v}" for k, v in TINY_KW.items()]
B_LOCAL = 2
T_TOTAL = 100
STEP_SEED, INIT_SEED = 4, 3
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5


# ---- the ranks' side (child processes: torch and the port only) ---------

def _port_train_config():
    return tconfig.Config(model=tconfig.ModelConfig(**TINY_KW),
                          optim=tconfig.OptimConfig(lr=1e-3, lower_lr=1e-4),
                          train=tconfig.TrainConfig(seed=STEP_SEED))


def _rank_infonce(rank, workdir):
    from segclip_tpu_torch.models.segclip import info_nce_pair
    inp = np.load(os.path.join(workdir, "infonce_in.npz"))
    rows = slice(rank * len(inp["t"]) // WORLD, (rank + 1) * len(inp["t"]) // WORLD)
    out = {}
    for variant in ("plain", "class_mask"):
        t = torch.from_numpy(inp["t"][rows]).requires_grad_()
        v = torch.from_numpy(inp["v"][rows]).requires_grad_()
        kw = {}
        if variant == "class_mask":
            kw = dict(text_class=torch.from_numpy(inp["tc"][rows]).long(),
                      scene_classes=torch.from_numpy(inp["sc"][rows]).long())
        loss = info_nce_pair(t, v, torch.tensor(np.log(10.0), dtype=torch.float32), **kw)
        (loss / WORLD).backward()
        out[f"{variant}/loss"] = (dist.all_reduce_(loss.detach().clone()) / WORLD).numpy()
        out[f"{variant}/grad_t"], out[f"{variant}/grad_v"] = t.grad.numpy(), v.grad.numpy()
    np.savez(os.path.join(workdir, f"infonce_{rank}.npz"), **out)


def _rank_step(rank, workdir):
    """make_train_step over step_in.npz's batches on this rank's rows, with
    its injected noise where it has some (else the step's own draws), and
    its "remat" and "accum" (grad_accum_steps) where it has them."""
    from segclip_tpu_torch.checkpoint.convert import load_into
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
    inp = np.load(os.path.join(workdir, "step_in.npz"))
    cfg = _port_train_config()
    if "remat" in inp.files:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, remat=bool(inp["remat"])),
            train=dataclasses.replace(cfg.train, grad_accum_steps=int(inp["accum"])))
    model = SegCLIP(cfg.model)
    load_into(model, torch.load(os.path.join(workdir, "init.pt"), weights_only=True))
    optimizer = create_optimizer(model, cfg, t_total=T_TOTAL)
    step = make_train_step(model, optimizer, cfg)
    state = TrainState(step=0, seed=STEP_SEED)
    rows = slice(rank * B_LOCAL, (rank + 1) * B_LOCAL)
    metrics = []
    for i in range(int(inp["steps"])):
        batch = {k: torch.from_numpy(inp[f"{i}/{k}"][rows]) for k in
                 ("input_ids", "attention_mask", "image", "image_seg")}
        for k in ("input_ids", "attention_mask", "image_seg"):
            batch[k] = batch[k].long()
        noise = None
        if "noise/gumbel" in inp.files:
            noise = {k: torch.from_numpy(inp[f"noise/{k}"][rows])
                     for k in ("gumbel", "gumbel_mae", "mask_vis")}
        metrics.append({k: float(v) for k, v in step(state, batch, noise).items()})
    torch.save({"metrics": metrics, "model": model.state_dict(),
                "step_count": optimizer.step_count, "step": state.step},
               os.path.join(workdir, f"step_{rank}.pt"))


def loop_config(output_dir):
    return tconfig.apply_overrides(tconfig.Config(), TINY_OPTS + [
        "data.datatype=synthetic", "data.batch_size=256", "data.transfer=rgb",
        "data.max_words=12", "train.eval_each_epoch=false", "train.epochs=1",
        f"train.output_dir={output_dir}"])


def _rank_loop(rank, workdir):
    from segclip_tpu_torch.train import loop as tloop
    seen = []

    def factory(model, optimizer, cfg):
        def step(state, batch, noise=None):
            seen.append({k: v.numpy() for k, v in batch.items()})
            state.step += 1
            return {"loss": torch.tensor(1.0)}
        return step

    with mock.patch.object(tloop, "make_train_step", factory):
        tloop.train(loop_config(os.path.join(workdir, "loop")), device="cpu")
    np.savez(os.path.join(workdir, f"loop_{rank}.npz"),
             **{f"{i}/{k}": v for i, batch in enumerate(seen) for k, v in batch.items()})


SCENARIOS = {"infonce": _rank_infonce, "step": _rank_step, "loop": _rank_loop}


def _rank_main(scenario, rank, world, rendezvous, workdir):
    torch.set_num_threads(1)
    dist.init_distributed("cpu", rendezvous, world, rank)
    try:
        SCENARIOS[scenario](rank, workdir)
    finally:
        dist.shutdown()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("segclip_tpu", "jax", "flax"))
    if leaked:
        raise SystemExit(f"rank {rank} imported {leaked[:5]}")


# ---- the test process's side ---------------------------------------------

def run_ranks(argv_of_rank, timeout=RANK_TIMEOUT_S):
    """Start one process per rank (argv_of_rank(rank) after the
    interpreter), wait for all within `timeout` and return their stderr;
    every rank must exit 0."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable] + argv_of_rank(r), cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return [err for _, err in outs]


def run_scenario(scenario, workdir):
    rendezvous = f"file://{workdir}/rendezvous_{scenario}"
    return run_ranks(lambda r: [os.path.abspath(__file__), scenario, str(r), str(WORLD),
                                rendezvous, str(workdir)])


@pytest.fixture(scope="module")
def infonce(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("infonce")
    rng = np.random.default_rng(5)
    b, e = 8, 16
    tc = rng.integers(0, 7, size=b).astype(np.int32)
    inp = dict(t=rng.normal(size=(b, e)).astype(np.float32),
               v=rng.normal(size=(b, e)).astype(np.float32), tc=tc,
               sc=(rng.integers(0, 64, size=b)
                   | np.where(tc > 0, 1 << np.maximum(tc - 1, 0), 0)).astype(np.int32))
    np.savez(workdir / "infonce_in.npz", **inp)
    run_scenario("infonce", workdir)
    return inp, [np.load(workdir / f"infonce_{r}.npz") for r in range(WORLD)]


def _jax_infonce(inp, variant):
    import jax
    import jax.numpy as jnp
    from segclip_tpu.models.segclip import info_nce_pair
    kw = {}
    if variant == "class_mask":
        kw = dict(text_class=jnp.asarray(inp["tc"]), scene_classes=jnp.asarray(inp["sc"]))
    ls = jnp.asarray(np.log(10.0), jnp.float32)
    loss, grads = jax.value_and_grad(
        lambda t, v: info_nce_pair(t, v, ls, **kw), argnums=(0, 1))(
        jnp.asarray(inp["t"]), jnp.asarray(inp["v"]))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("variant", ["plain", "class_mask"])
def test_infonce_sharded_equals_global(infonce, variant):
    inp, ranks = infonce
    want, _ = _jax_infonce(inp, variant)
    for res in ranks:                 # the mean over the ranks, on every rank
        np.testing.assert_allclose(float(res[f"{variant}/loss"]), want, rtol=1e-5)
    if variant == "class_mask":
        assert abs(want - _jax_infonce(inp, "plain")[0]) > 1e-4


@pytest.mark.parametrize("variant", ["plain", "class_mask"])
def test_infonce_gradients_flow_through_the_gather(infonce, variant):
    """The local loss / world, differentiated on each rank, gives the
    global loss's gradient rows: the gather's backward sums across ranks."""
    inp, ranks = infonce
    _, (gt, gv) = _jax_infonce(inp, variant)
    for which, want in (("grad_t", gt), ("grad_v", gv)):
        got = np.concatenate([res[f"{variant}/{which}"] for res in ranks])
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6, err_msg=which)


def _step_inputs(steps=3):
    from segclip_tpu.config import ModelConfig
    cfg = ModelConfig(**TINY_KW)
    rng = np.random.default_rng(8)
    b, g, l = WORLD * B_LOCAL, cfg.group_num, cfg.num_patches
    kept = int((l + 1) * (1 - cfg.mae_vis_mask_ratio)) - 1
    out = {"steps": np.asarray(steps),
           "noise/gumbel": rng.gumbel(size=(b, g, l)).astype(np.float32),
           "noise/gumbel_mae": rng.gumbel(size=(b, g, kept)).astype(np.float32),
           "noise/mask_vis": rng.random((b, l + 1)).astype(np.float32)}
    for i in range(steps):
        ids = np.zeros((b, cfg.max_words), np.int32)
        ids[:, 0] = 510
        for j, n in enumerate(rng.integers(2, 8, size=b)):
            ids[j, 1:n] = rng.integers(1, 500, size=n - 1)
            ids[j, n] = 511
        image = (rng.normal(size=(b, 32, 32, 3)) * 0.4).astype(np.float32)
        if i == 1:
            image[B_LOCAL:] = np.nan          # rank 1's half of step 2
        out.update({f"{i}/input_ids": ids, f"{i}/attention_mask": (ids != 0).astype(np.int32),
                    f"{i}/image": image,
                    f"{i}/image_seg": rng.integers(0, 4, size=(b, 4, 4)).astype(np.int32)})
    return out


def _jax_sharded_steps(jparams, inp):
    """make_sharded_train_step over a 2-device mesh, with the global noise
    injected: each shard's draw takes its rows by axis_index."""
    import jax
    import jax.numpy as jnp
    from segclip_tpu.config import Config, ModelConfig, OptimConfig, TrainConfig
    from segclip_tpu.models import clip as jclip
    from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
    from segclip_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from segclip_tpu.train.step import create_train_state, make_sharded_train_step

    cfg = Config(model=ModelConfig(**TINY_KW), optim=OptimConfig(lr=1e-3, lower_lr=1e-4),
                 train=TrainConfig(seed=STEP_SEED))
    state, tx, trainable = create_train_state(cfg, jparams, t_total=T_TOTAL, seed=STEP_SEED)
    step = make_sharded_train_step(make_mesh(WORLD), JSegCLIP(cfg.model), tx,
                                   trainable=trainable)
    gumbels = {inp[f"noise/{k}"][:B_LOCAL].shape: inp[f"noise/{k}"]
               for k in ("gumbel", "gumbel_mae")}
    mask = inp["noise/mask_vis"]
    orig = jclip.random_masking

    def rows(full, b):
        return jax.lax.dynamic_slice_in_dim(jnp.asarray(full),
                                            jax.lax.axis_index(DATA_AXIS) * b, b)

    def masking(x, ratio, key=None, **kw):
        kw.pop("noise", None)
        return orig(x, ratio, noise=rows(mask, x.shape[0]), **kw)

    def gumbel(key, shape, dtype=jnp.float32):
        return rows(gumbels[tuple(shape)], shape[0])

    metrics = []
    with mock.patch.object(jclip, "random_masking", masking), \
            mock.patch("jax.random.gumbel", gumbel):
        for i in range(int(inp["steps"])):
            batch = {k: jnp.asarray(inp[f"{i}/{k}"]) for k in
                     ("input_ids", "attention_mask", "image", "image_seg")}
            state, m = step(state, batch)
            metrics.append(jax.tree_util.tree_map(float, m))
    return metrics, state


def test_train_steps_at_two_ranks_match_the_jax_sharded_step(tmp_path):
    import jax
    from segclip_tpu.config import ModelConfig
    from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
    from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax

    _, jparams = jax_init_segclip(ModelConfig(**TINY_KW), seed=INIT_SEED)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    torch.save(state_dict_from_jax(jparams, TINY_KW["vision_patch_size"]),
               tmp_path / "init.pt")
    inp = _step_inputs()
    np.savez(tmp_path / "step_in.npz", **inp)
    run_scenario("step", tmp_path)
    ranks = [torch.load(tmp_path / f"step_{r}.pt", weights_only=True) for r in range(WORLD)]
    jmetrics, state = _jax_sharded_steps(jparams, inp)

    np.testing.assert_array_equal(*[[list(m.values()) for m in res["metrics"]]
                                     for res in ranks])
    for i, (jm, tm) in enumerate(zip(jmetrics, ranks[0]["metrics"])):
        assert set(jm) == set(tm)
        for key in jm:
            if np.isnan(jm[key]):
                assert np.isnan(tm[key]), (i, key)
                continue
            np.testing.assert_allclose(tm[key], jm[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert [m["skipped_nan"] for m in ranks[0]["metrics"]] == [0.0, 1.0, 0.0]
    assert ranks[0]["step_count"] == int(state.opt_state.step) == 2
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                              TINY_KW["vision_patch_size"])
    for name, p in ranks[0]["model"].items():
        assert torch.equal(p, ranks[1]["model"][name]), name
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=PARAM_TOL, rtol=0,
                                   err_msg=name)


def test_a_nan_half_batch_skips_on_both_ranks(tmp_path):
    """Rank 1's half of the batch is NaN: both ranks skip the step (the
    loss is averaged across the ranks before the check), and the replicas
    stay equal to a run that never saw that step's update."""
    import jax
    from segclip_tpu.config import ModelConfig
    from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
    from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax

    _, jparams = jax_init_segclip(ModelConfig(**TINY_KW), seed=INIT_SEED)
    torch.save(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                   TINY_KW["vision_patch_size"]), tmp_path / "init.pt")
    inp = {k: v for k, v in _step_inputs().items() if not k.startswith("2/")}
    inp["steps"] = np.asarray(2)
    np.savez(tmp_path / "step_in.npz", **inp)
    run_scenario("step", tmp_path)
    ranks = [torch.load(tmp_path / f"step_{r}.pt", weights_only=True) for r in range(WORLD)]
    for res in ranks:
        assert [m["skipped_nan"] for m in res["metrics"]] == [0.0, 1.0]
        assert res["step_count"] == 1 and res["step"] == 2
    assert all(torch.equal(p, ranks[1]["model"][k]) for k, p in ranks[0]["model"].items())


def test_remat_composes_with_data_parallel_accumulation_and_the_nan_skip(tmp_path):
    """Two ranks, two micro-batches per rank, the step's own noise and rank
    1's NaN half of the second step: with ModelConfig.remat every metric of
    every step and both replicas' parameters equal the run without it, bit
    for bit, and both runs skip the NaN step."""
    from segclip_tpu_torch.models.segclip import init_segclip

    base = {k: v for k, v in _step_inputs().items() if not k.startswith("noise/")}
    init = init_segclip(tconfig.ModelConfig(**TINY_KW), seed=INIT_SEED).state_dict()
    runs = []
    for remat in (0, 1):
        workdir = tmp_path / f"remat{remat}"
        workdir.mkdir()
        torch.save(init, workdir / "init.pt")
        np.savez(workdir / "step_in.npz", **base, remat=np.asarray(remat), accum=np.asarray(2))
        run_scenario("step", workdir)
        runs.append([torch.load(workdir / f"step_{r}.pt", weights_only=True)
                     for r in range(WORLD)])
    for plain, remat in zip(*runs):
        assert [m["skipped_nan"] for m in plain["metrics"]] == [0.0, 1.0, 0.0]
        assert [list(m) for m in plain["metrics"]] == [list(m) for m in remat["metrics"]]
        np.testing.assert_array_equal([list(m.values()) for m in plain["metrics"]],
                                      [list(m.values()) for m in remat["metrics"]])
        assert plain["step_count"] == remat["step_count"] == 2
        for name, p in plain["model"].items():
            assert torch.equal(p, remat["model"][name]), name
    assert all(torch.equal(p, runs[1][1]["model"][k]) for k, p in runs[1][0]["model"].items())


def test_loop_batches_per_rank_are_the_jax_shards(tmp_path):
    from segclip_tpu import config as jconfig
    from segclip_tpu.data.pipeline import BatchLoader, ShardedEpochSampler, build_dataset

    run_scenario("loop", tmp_path)
    cfg = loop_config(str(tmp_path / "unused"))
    data = jconfig.DataConfig(**{k: getattr(cfg.data, k)
                                 for k in jconfig.DataConfig.__dataclass_fields__})
    dataset = build_dataset(data, use_seg=cfg.model.use_seglabel, normalize=False,
                            vocab_size=cfg.model.vocab_size,
                            image_size=cfg.model.image_resolution,
                            patch_size=cfg.model.vision_patch_size)
    one = ShardedEpochSampler(len(dataset), cfg.data.batch_size, seed=cfg.train.seed)
    shards = [ShardedEpochSampler(len(dataset), cfg.data.batch_size, shard=r,
                                  num_shards=WORLD, seed=cfg.train.seed)
              for r in range(WORLD)]
    np.testing.assert_array_equal(
        np.concatenate([s.epoch_indices(0) for s in shards], axis=1), one.epoch_indices(0))
    for r, sampler in enumerate(shards):
        got = np.load(tmp_path / f"loop_{r}.npz")
        want = list(BatchLoader(dataset, sampler, seed=cfg.train.seed).epoch(0))
        assert len(want) == one.steps == 2
        assert sorted(got.files) == sorted(f"{i}/{k}" for i in range(2) for k in want[0])
        for i, batch in enumerate(want):
            for key, value in batch.items():
                assert len(value) == cfg.data.batch_size // WORLD
                np.testing.assert_array_equal(got[f"{i}/{key}"], value, err_msg=key)


def _train_cli(out, rendezvous, *extra):
    return lambda r: (["-m", "segclip_tpu_torch.cli.train", "--device", "cpu",
                       "--datatype", "synthetic", "--batch-size", "256", "--epochs", "2",
                       "--max-words", "12", "--n-display", "1", "--output-dir", str(out),
                       "--dist-coordinator", rendezvous, "--dist-num-processes",
                       str(WORLD), "--dist-process-id", str(r)] + list(extra)
                      + ["--opts"] + TINY_OPTS + ["train.eval_each_epoch=false"])


def test_train_cli_at_two_ranks_writes_on_rank0_and_resumes_bit_for_bit(tmp_path):
    run_a, run_b = tmp_path / "a", tmp_path / "b"
    errs = run_ranks(_train_cli(run_a, f"file://{tmp_path}/rendezvous_a"))
    assert "checkpoint saved" in errs[0] and "checkpoint saved" not in errs[1]
    assert all("backend gloo" in e for e in errs)
    with open(run_a / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    assert [m["step"] for m in metrics] == [1, 2, 3, 4]         # rank 0's lines only
    assert sorted(os.listdir(run_a)) == ["ckpt_epoch_0", "ckpt_epoch_1", "log.txt",
                                         "metrics.jsonl"]
    shutil.copytree(run_a / "ckpt_epoch_0", run_b / "ckpt_epoch_0")
    run_ranks(_train_cli(run_b, f"file://{tmp_path}/rendezvous_b", "--do-resume"))
    with open(run_b / "metrics.jsonl") as f:
        resumed = [json.loads(line) for line in f]
    assert [m["epoch"] for m in resumed] == [1, 1]
    assert resumed[-1]["loss"] == metrics[-1]["loss"]
    for name in ("model.pt", "train_state.pt"):
        a = torch.load(run_a / "ckpt_epoch_1" / name, weights_only=True)
        b = torch.load(run_b / "ckpt_epoch_1" / name, weights_only=True)
        if name == "model.pt":
            assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert {k: a[k] for k in a if k != "optimizer"} == \
                {k: b[k] for k in b if k != "optimizer"}


def test_dist_settings_are_checked_before_any_rendezvous(monkeypatch):
    for var in ("SEGCLIP_DIST", "SEGCLIP_DIST_COORDINATOR", "SEGCLIP_DIST_NPROCS",
                "SEGCLIP_DIST_PROCID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--dist-num-processes"):
        dist.init_distributed("cpu", "localhost:1")
    with pytest.raises(ValueError, match="--dist-coordinator"):
        dist.init_distributed("cpu", None, 2, 0)
    with pytest.raises(ValueError, match="out of range"):
        dist.init_distributed("cpu", "localhost:1", 2, 2)
    monkeypatch.setenv("SEGCLIP_DIST", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        dist.init_distributed("cpu")
    monkeypatch.delenv("SEGCLIP_DIST")
    assert dist.init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized() and dist.world_size() == 1 and dist.rank() == 0


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

"""Tensor parallelism in the port (parallel/gspmd.py, train.tensor_parallelism
> 1) on the CPU, over gloo ranks started as child processes of this file
(`python tests/test_torch_tensor_parallel.py <scenario> <rank> <world> <tp>
<rendezvous> <workdir>`, a `file://` rendezvous under the test's temporary
directory, 60 s per rank) or of the train CLI, against the JAX package's
GSPMD step on the conftest's simulated mesh. The children import torch and
the port only; the JAX side runs in the test process.

  - the parameters the port shards, and the dim of each, are those JAX's
    `param_shardings` shards on a (1, 2) mesh, through torch_export's names;
  - `shard_state_dict` then `gather_state_dict` gives every parameter and
    every moment back bit for bit;
  - three float32 steps at dp1 × tp2 (2 ranks) and dp2 × tp2 (4 ranks) equal
    `make_gspmd_train_step` with the same noise injected: losses rtol 1e-5,
    every gathered parameter within 1e-5, the model peers' replicated
    parameters bit-identical, the bytes all-reduced over the model row the
    same each step; at dp1 × tp2 with a 1-head visual tower, whose
    attention stays replicated here (JAX splits it by width); and at dp1 ×
    tp2 with `remat` on both sides (the recompute runs the attention's
    all-reduce again, in the same order on both ranks);
  - the train CLI at tp = 2 on 2 ranks is deterministic across runs, writes
    the tp = 1 layout, evaluates a full copy each epoch, resumes at tp = 2
    bit for bit, and its checkpoint resumes at tp = 1.

The dp2 case leaves the text MAE loss off: the JAX GSPMD step averages it
over the global batch's scored tokens, a data-parallel step over each
shard's (the port's data-parallel step is held to JAX's shard_map step in
tests/test_torch_parallel.py).
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
from PIL import Image

from segclip_tpu_torch import config as tconfig
from segclip_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 60
TP_KW = dict(image_resolution=32, vision_patch_size=8, vision_width=128,
             vision_layers=4, first_stage_layer=3, group_num=4, cross_layer=1,
             context_length=16, vocab_size=512, transformer_width=128,
             transformer_layers=2, embed_dim=32, max_words=12,
             use_vision_mae_recon=True, use_text_mae_recon=True, use_seglabel=True,
             mae_decoder_depth=1, mae_decoder_num_heads=2, compute_dtype="float32",
             grouping_impl="jnp")
# (data, model) ranks and the config of each step case
STEP_CASES = {
    "dp1_tp2": (1, 2, TP_KW),
    "dp2_tp2": (2, 2, {**TP_KW, "use_text_mae_recon": False}),
    "dp1_tp2_one_head": (1, 2, {**TP_KW, "vision_width": 64}),
    "dp1_tp2_remat": (1, 2, {**TP_KW, "remat": True}),
}
B = 4
T_TOTAL = 100
STEP_SEED, INIT_SEED = 4, 3
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
# the CLI keeps the default vocabulary and context (the per-epoch eval's
# text bank comes from the real tokenizer), and is shallower: each rank
# steps on the whole 256-sample batch
CLI_OPTS = [f"model.{k}={v}" for k, v in {
    **TP_KW, "vision_layers": 2, "first_stage_layer": 1, "transformer_layers": 1,
    "use_text_mae_recon": False}.items()
    if k not in ("grouping_impl", "vocab_size", "context_length")]


def _train_config(kw):
    return tconfig.Config(model=tconfig.ModelConfig(**kw),
                          optim=tconfig.OptimConfig(lr=1e-3, lower_lr=1e-4),
                          train=tconfig.TrainConfig(seed=STEP_SEED))


# ---- the ranks' side (child processes: torch and the port only) ---------

def _full_model(cfg, workdir):
    from segclip_tpu_torch.checkpoint.convert import load_into
    from segclip_tpu_torch.models.segclip import SegCLIP
    model = SegCLIP(cfg.model)
    load_into(model, torch.load(os.path.join(workdir, "init.pt"), weights_only=True))
    return model


def _rank_roundtrip(rank, workdir, case):
    from segclip_tpu_torch.parallel import gspmd
    from segclip_tpu_torch.train.step import create_optimizer
    cfg = _train_config(TP_KW)
    model = _full_model(cfg, workdir)
    optimizer = create_optimizer(model, cfg, t_total=T_TOTAL)
    gen = torch.Generator().manual_seed(11)
    for p in model.parameters():
        if p.requires_grad:
            optimizer.state[p] = {k: torch.randn(p.shape, generator=gen)
                                  for k in ("exp_avg", "exp_avg_sq")}
    full_model, full_opt = model.state_dict(), optimizer.state_dict()
    gspmd.shard_model_(model)
    optimizer = create_optimizer(model, cfg, t_total=T_TOTAL)
    local_model, local_opt = gspmd.shard_state_dict(model, full_model, full_opt)
    model.load_state_dict(local_model)
    optimizer.load_state_dict(local_opt)
    got_model, got_opt = gspmd.gather_state_dict(model, optimizer.state_dict())
    same = {f"model/{k}": torch.equal(v, got_model[k]) for k, v in full_model.items()}
    same.update({f"moment/{i}/{k}": torch.equal(v, got_opt["state"][i][k])
                 for i, moments in full_opt["state"].items() for k, v in moments.items()})
    shapes_differ = sum(tuple(v.shape) != tuple(local_model[k].shape)
                        for k, v in full_model.items())
    with open(os.path.join(workdir, f"roundtrip_{rank}.json"), "w") as f:
        json.dump({"same": same, "sharded": shapes_differ,
                   "keys": sorted(got_model) == sorted(full_model)}, f)


def _rank_step(rank, workdir, case):
    from segclip_tpu_torch.models import layers
    from segclip_tpu_torch.parallel import gspmd
    from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step
    cfg = _train_config(STEP_CASES[case][2])
    model = _full_model(cfg, workdir)
    specs = gspmd.shard_model_(model)
    optimizer = create_optimizer(model, cfg, t_total=T_TOTAL)
    step = make_train_step(model, optimizer, cfg)
    state = TrainState(step=0, seed=STEP_SEED)
    inp = np.load(os.path.join(workdir, "step_in.npz"))
    b = B // dist.data_size()
    rows = slice(dist.data_rank() * b, (dist.data_rank() + 1) * b)
    noise = {k: torch.from_numpy(inp[f"noise/{k}"][rows]) for k in
             ("gumbel", "gumbel_mae", "mask_vis", "mask_txt")}
    metrics, sent, checkpointed = [], [], 0
    for i in range(int(inp["steps"])):
        batch = {k: torch.from_numpy(inp[f"{i}/{k}"][rows]) for k in
                 ("input_ids", "attention_mask", "image", "image_seg")}
        for k in ("input_ids", "attention_mask", "image_seg"):
            batch[k] = batch[k].long()
        before = gspmd.model_group_sum.bytes
        with mock.patch.object(layers, "checkpoint", wraps=layers.checkpoint) as ckpt:
            metrics.append({k: float(v) for k, v in step(state, batch, noise).items()})
        sent.append(gspmd.model_group_sum.bytes - before)
        checkpointed += ckpt.call_count
    full, _ = gspmd.gather_state_dict(model)
    torch.save({"metrics": metrics, "bytes": sent, "checkpointed": checkpointed,
                "full": full, "local": model.state_dict(),
                "sharded": sorted(n for n, s in specs.items() if s is not None),
                "grid": (dist.data_rank(), dist.model_rank())},
               os.path.join(workdir, f"step_{rank}.pt"))


SCENARIOS = {"roundtrip": _rank_roundtrip, "step": _rank_step}


def _rank_main(scenario, rank, world, tp, rendezvous, workdir, case):
    torch.set_num_threads(1)
    dist.init_distributed("cpu", rendezvous, world, rank)
    try:
        dist.init_grid(tp)
        SCENARIOS[scenario](rank, workdir, case)
    finally:
        dist.shutdown()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("segclip_tpu", "jax", "flax"))
    if leaked:
        raise SystemExit(f"rank {rank} imported {leaked[:5]}")


# ---- the test process's side ---------------------------------------------

def start_ranks(world, argv_of_rank):
    """Start one process per rank (argv_of_rank(rank) after the interpreter)."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable] + argv_of_rank(r), cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def wait_ranks(procs, timeout=RANK_TIMEOUT_S):
    """Wait for every rank within `timeout` and return their stderr; every
    rank must exit 0."""
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


def run_ranks(world, argv_of_rank):
    return wait_ranks(start_ranks(world, argv_of_rank))


def start_scenario(scenario, workdir, world, tp, case="-"):
    rendezvous = f"file://{workdir}/rendezvous_{scenario}"
    return start_ranks(world, lambda r: [os.path.abspath(__file__), scenario, str(r),
                                         str(world), str(tp), rendezvous, str(workdir),
                                         case])


def _jax_init(kw, path):
    """The seeded JAX init, its params as numpy, written as the port's
    init.pt at `path`."""
    import jax
    from segclip_tpu.config import ModelConfig
    from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
    from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax
    _, jparams = jax_init_segclip(ModelConfig(**kw), seed=INIT_SEED)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    torch.save(state_dict_from_jax(jparams, kw["vision_patch_size"]), path)
    return jparams


def _jax_names(jparams):
    """{JAX leaf path: (torch name, transposed)} through torch_export's
    export_state_dict: each leaf is filled with its index."""
    import jax
    from segclip_tpu_torch.checkpoint.torch_export import export_state_dict
    paths, leaves = [], []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        paths.append("/".join(k.key for k in path))
        leaves.append(leaf)
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])
    names = {}
    for name, value in export_state_dict(tagged, vision_patch_size=8).items():
        path = paths[int(value.reshape(-1)[0])]
        names[path] = (name, path.endswith("kernel") and value.ndim == 2)
    return names


def test_sharded_parameters_and_dims_are_jax_param_shardings():
    """(a) Which parameters are sharded, and along which dim, equals JAX's
    param_shardings on a (1, 2) mesh (the JAX kernels are (in, out), so a
    transposed kernel's dim d is the port's 1 − d)."""
    import jax
    from segclip_tpu.config import ModelConfig
    from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
    from segclip_tpu.parallel.gspmd import MODEL_AXIS, make_dp_tp_mesh, param_shardings
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.parallel.gspmd import shard_specs

    _, jparams = jax_init_segclip(ModelConfig(**TP_KW), seed=INIT_SEED)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    shardings = param_shardings(jparams, make_dp_tp_mesh(1, 2))
    names = _jax_names(jparams)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        path = "/".join(k.key for k in path)
        dims = [d for d, axis in enumerate(sh.spec) if axis == MODEL_AXIS]
        if dims:
            name, transposed = names[path]
            want[name] = 1 - dims[0] if transposed else dims[0]
    specs = shard_specs(SegCLIP(tconfig.ModelConfig(**TP_KW)), 2)
    got = {name: spec.dim for name, spec in specs.items() if spec is not None}
    assert len(want) > 40
    assert got == want
    assert specs["clip.transformer.resblocks.0.attn.in_proj_weight"].blocks == 3
    assert specs["vis_mae_decoder.decoder_blocks.0.attn.qkv.weight"].blocks == 3


@pytest.mark.parametrize("entry", ["shard_model_", "gather_state_dict", "shard_state_dict"])
def test_sharding_without_a_grid_raises(entry):
    """Without the data × model grid, the gspmd entry points raise: no
    model row means no sharding, never a fall-back to the whole world."""
    from segclip_tpu_torch.models.segclip import SegCLIP
    from segclip_tpu_torch.parallel import gspmd

    model = SegCLIP(tconfig.ModelConfig(**TP_KW))
    args = {"shard_model_": (model,), "gather_state_dict": (model,),
            "shard_state_dict": (model, model.state_dict())}[entry]
    assert dist.model_group() is None
    with pytest.raises(RuntimeError, match="init_grid"):
        getattr(gspmd, entry)(*args)


def test_shard_then_gather_gives_every_parameter_and_moment_back(tmp_path):
    """(b) shard_state_dict then gather_state_dict, bit for bit."""
    _jax_init(TP_KW, tmp_path / "init.pt")
    wait_ranks(start_scenario("roundtrip", tmp_path, 2, 2))
    for r in range(2):
        with open(tmp_path / f"roundtrip_{r}.json") as f:
            res = json.load(f)
        assert res["keys"] and res["sharded"] > 40
        assert len([k for k in res["same"] if k.startswith("moment/")]) > 100
        assert all(res["same"].values()), [k for k, v in res["same"].items() if not v]


def _step_inputs(kw, steps=3):
    from segclip_tpu.config import ModelConfig
    cfg = ModelConfig(**kw)
    rng = np.random.default_rng(8)
    g, l = cfg.group_num, cfg.num_patches
    kept = int((l + 1) * (1 - cfg.mae_vis_mask_ratio)) - 1
    out = {"steps": np.asarray(steps),
           "noise/gumbel": rng.gumbel(size=(B, g, l)).astype(np.float32),
           "noise/gumbel_mae": rng.gumbel(size=(B, g, kept)).astype(np.float32),
           "noise/mask_vis": rng.random((B, l + 1)).astype(np.float32),
           "noise/mask_txt": rng.random((B, cfg.max_words)).astype(np.float32)}
    for i in range(steps):
        ids = np.zeros((B, cfg.max_words), np.int32)
        ids[:, 0] = 510
        for j, n in enumerate(rng.integers(2, 8, size=B)):
            ids[j, 1:n] = rng.integers(1, 500, size=n - 1)
            ids[j, n] = 511
        out.update({f"{i}/input_ids": ids, f"{i}/attention_mask": (ids != 0).astype(np.int32),
                    f"{i}/image": (rng.normal(size=(B, 32, 32, 3)) * 0.4).astype(np.float32),
                    f"{i}/image_seg": rng.integers(0, 4, size=(B, 4, 4)).astype(np.int32)})
    return out


def _jax_gspmd_steps(kw, n_data, n_model, jparams, inp):
    """make_gspmd_train_step on an (n_data, n_model) mesh: the global-batch
    program, the global noise injected by shape."""
    import jax
    import jax.numpy as jnp
    from segclip_tpu.config import Config, ModelConfig, OptimConfig, TrainConfig
    from segclip_tpu.models import clip as jclip
    from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
    from segclip_tpu.parallel.gspmd import make_dp_tp_mesh, make_gspmd_train_step
    from segclip_tpu.train.step import create_train_state

    cfg = Config(model=ModelConfig(**kw), optim=OptimConfig(lr=1e-3, lower_lr=1e-4),
                 train=TrainConfig(seed=STEP_SEED))
    state, tx, trainable = create_train_state(cfg, jparams, t_total=T_TOTAL, seed=STEP_SEED)
    step, place_state, place_batch = make_gspmd_train_step(
        make_dp_tp_mesh(n_data, n_model), JSegCLIP(cfg.model), tx, state,
        trainable=trainable)
    state = place_state(state)
    gumbels = {inp[f"noise/{k}"].shape: inp[f"noise/{k}"] for k in ("gumbel", "gumbel_mae")}
    masks = {inp[f"noise/{k}"].shape[1]: inp[f"noise/{k}"] for k in ("mask_vis", "mask_txt")}
    orig = jclip.random_masking

    def masking(x, ratio, key=None, **kwargs):
        kwargs.pop("noise", None)
        return orig(x, ratio, noise=jnp.asarray(masks[x.shape[1]]), **kwargs)

    def gumbel(key, shape, dtype=jnp.float32):
        return jnp.asarray(gumbels[tuple(shape)])

    metrics = []
    with mock.patch.object(jclip, "random_masking", masking), \
            mock.patch("jax.random.gumbel", gumbel):
        for i in range(int(inp["steps"])):
            batch = {k: inp[f"{i}/{k}"] for k in
                     ("input_ids", "attention_mask", "image", "image_seg")}
            state, m = step(state, place_batch(batch))
            metrics.append(jax.tree_util.tree_map(float, m))
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_steps_equal_the_jax_gspmd_step(tmp_path, case):
    """(c) and (e): three float32 steps of the dp × tp grid against JAX's
    GSPMD step on the same mesh shape."""
    from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax
    n_data, n_model, kw = STEP_CASES[case]
    world = n_data * n_model
    jparams = _jax_init(kw, tmp_path / "init.pt")
    inp = _step_inputs(kw)
    np.savez(tmp_path / "step_in.npz", **inp)
    procs = start_scenario("step", tmp_path, world, n_model, case)
    jmetrics, jfinal = _jax_gspmd_steps(kw, n_data, n_model, jparams, inp)
    wait_ranks(procs)
    ranks = [torch.load(tmp_path / f"step_{r}.pt", weights_only=True) for r in range(world)]

    assert [tuple(r["grid"]) for r in ranks] == [divmod(r, n_model) for r in range(world)]
    for i, (jm, tm) in enumerate(zip(jmetrics, ranks[0]["metrics"])):
        for key in ("loss", "sim_loss", "seglabel_loss", "vis_mae_loss", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    # every all-reduce counted, the recompute's too: the same bytes each step
    assert all(len(set(r["bytes"])) == 1 and r["bytes"][0] > 0 for r in ranks)
    assert all((r["checkpointed"] > 0) == kw.get("remat", False) for r in ranks)
    ref = state_dict_from_jax(jfinal, kw["vision_patch_size"])
    for name, p in ranks[0]["full"].items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=PARAM_TOL, rtol=0,
                                   err_msg=name)
    sharded = set(ranks[0]["sharded"])
    for row in range(n_data):
        peers = ranks[row * n_model:(row + 1) * n_model]
        for name, p in peers[0]["local"].items():
            if name not in sharded:
                assert all(torch.equal(p, q["local"][name]) for q in peers[1:]), name
    attn = "clip.visual.transformer.layers0.0.attn.in_proj_weight"
    mlp = "clip.visual.transformer.layers0.0.mlp.c_fc.weight"
    assert mlp in sharded and (attn in sharded) == (case != "dp1_tp2_one_head")


# ---- the train CLI at tp = 2 ---------------------------------------------

def _voc(root, n=2):
    rng = np.random.default_rng(3)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (root / d).mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)).save(
            root / "JPEGImages" / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 21, (40, 48)).astype(np.uint8)).save(
            root / "SegmentationClass" / f"img{i}.png")
    (root / "ImageSets/Segmentation/val.txt").write_text(
        "\n".join(f"img{i}" for i in range(n)) + "\n")
    return root


def _cli_argv(out, voc, *extra, tp=2):
    return (["-m", "segclip_tpu_torch.cli.train", "--device", "cpu", "--datatype",
             "synthetic", "--batch-size", "256", "--epochs", "2", "--max-words", "12",
             "--n-display", "1", "--output-dir", str(out), "--eval-each-epoch",
             "--eval-data-root", str(voc)] + list(extra)
            + ["--opts"] + CLI_OPTS + [f"train.tensor_parallelism={tp}"])


def _run_cli(out, voc, rendezvous, *extra):
    return run_ranks(2, lambda r: _cli_argv(
        out, voc, "--dist-coordinator", rendezvous, "--dist-num-processes", "2",
        "--dist-process-id", str(r), *extra))


def _read(run, name):
    return torch.load(run / name, weights_only=True)


def _same_checkpoint(x, y):
    """The two checkpoint directories hold equal tensors and counters."""
    mx, my = _read(x, "model.pt"), _read(y, "model.pt")
    assert mx.keys() == my.keys() and all(torch.equal(mx[k], my[k]) for k in mx)
    sx, sy = _read(x, "train_state.pt"), _read(y, "train_state.pt")
    assert {k: v for k, v in sx.items() if k != "optimizer"} == \
        {k: v for k, v in sy.items() if k != "optimizer"}
    ox, oy = sx["optimizer"]["state"], sy["optimizer"]["state"]
    assert ox.keys() == oy.keys()
    assert all(torch.equal(ox[i][k], oy[i][k]) for i in ox for k in ox[i])


def _metrics(run):
    """metrics.jsonl's lines without their wall-clock "time"."""
    with open(run / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def test_train_cli_at_tp2_is_deterministic_writes_tp1_layout_and_resumes(tmp_path):
    """(d) Two runs agree; model.pt has the tp = 1 keys and shapes and
    evaluates to the logged mIoU; a resume at tp = 2 from epoch 0
    reproduces epoch 1 bit for bit, and one at tp = 1 resumes too."""
    from segclip_tpu_torch.cli import eval_zeroshot
    from segclip_tpu_torch.cli import train as train_cli
    from segclip_tpu_torch.models.segclip import SegCLIP

    voc = _voc(tmp_path / "voc")
    a, b, c = tmp_path / "a", tmp_path / "b", tmp_path / "c"
    errs = _run_cli(a, voc, f"file://{tmp_path}/rendezvous_a")
    assert all("grid: dp 1 × tp 2 (backend gloo)" in e for e in errs)
    _run_cli(b, voc, f"file://{tmp_path}/rendezvous_b")
    ma, mb = _metrics(a), _metrics(b)
    assert ma == mb and len([m for m in ma if "miou" in m]) == 2
    _same_checkpoint(a / "ckpt_epoch_1", b / "ckpt_epoch_1")

    cfg = tconfig.apply_overrides(tconfig.Config(), CLI_OPTS)
    want = {k: tuple(v.shape) for k, v in SegCLIP(cfg.model).state_dict().items()}
    model_pt = _read(a / "ckpt_epoch_1", "model.pt")
    assert {k: tuple(v.shape) for k, v in model_pt.items()} == want
    moments = _read(a / "ckpt_epoch_1", "train_state.pt")["optimizer"]
    names = dict(zip(*[sum((g[k] for g in moments["param_groups"]), [])
                       for k in ("params", "param_names")]))
    assert all(tuple(m["exp_avg"].shape) == want[names[i]]
               for i, m in moments["state"].items())
    single = eval_zeroshot.main(["--device", "cpu", "--dataset", "voc", "--data-root",
                                 str(voc), "--init-model", str(a / "ckpt_epoch_1" / "model.pt"),
                                 "--output-dir", str(tmp_path / "eval"), "--opts"]
                                + [o.split("model.", 1)[1] for o in CLI_OPTS])
    assert single["mIoU"] == pytest.approx([m["miou"] for m in ma if "miou" in m][-1],
                                           abs=1e-6)

    shutil.copytree(a / "ckpt_epoch_0", c / "ckpt_epoch_0")
    _run_cli(c, voc, f"file://{tmp_path}/rendezvous_c", "--do-resume")
    assert [m["epoch"] for m in _metrics(c)] == [1, 1, 1]
    assert _metrics(c)[-1] == ma[-1]
    _same_checkpoint(a / "ckpt_epoch_1", c / "ckpt_epoch_1")

    d = tmp_path / "d"
    shutil.copytree(a / "ckpt_epoch_0", d / "ckpt_epoch_0")
    argv = _cli_argv(d, voc, "--do-resume", tp=1)[2:]
    result = train_cli.main(argv)
    assert result["epochs_run"] == 1
    last = [m for m in _metrics(d) if "loss" in m][-1]
    np.testing.assert_allclose(last["loss"], [m for m in ma if "loss" in m][-1]["loss"],
                               rtol=1e-4)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
               sys.argv[5], sys.argv[6], sys.argv[7])

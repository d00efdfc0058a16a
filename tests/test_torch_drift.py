"""The JAX package's 12-step training trajectory
(tests/test_training_drift.py) replayed on the port, on the CPU.

The port cannot reproduce JAX's random streams, so JAX's own draws are
recorded: `run_trajectory` runs unchanged while `jax.random.gumbel` and
`jax.random.uniform` return their draw untouched and hand a copy to a
`jax.debug.callback`. Each step's draws map, by shape, to the port's
`NOISE_KEYS` (the Gumbel noise of the grouping path and of the MAE path,
the vision and text masking noise). `tests/fixtures/torch_drift.npz`
holds the JAX init in the reference layout (`sd/*`), the batch
(`batch/*`), the draws of every step (`noise/*`, stacked over the steps)
and JAX's losses (`losses`). Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_drift.py

Tier-1 checks: the fixture's parameters equal `export_state_dict` of
`init_segclip(TINY, seed=3)` bit for bit; its losses are within
rtol 5e-4 of `GOLDEN_LOSSES` (test_training_drift.py's bound); the port's
12 float32 steps from it, its draws injected through
`make_train_step(...)(state, batch, noise)`, give every step's loss within
rtol 5e-4 of the fixture's (chip_smoke.py's phase 14 replays them on the
card through the same functions, from the fixture's stored config). The slow test records JAX's run again and
compares it with the fixture (the draws bit for bit, the losses to 1e-6).
"""
import dataclasses
import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax

# the repository root, for `python tests/test_torch_drift.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from segclip_tpu.checkpoint.torch_export import export_state_dict
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip

import test_training_drift as drift
from test_torch_convert import chip_smoke
from test_torch_train import port_config
from segclip_tpu_torch.models.segclip import NOISE_KEYS

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "torch_drift.npz")
RTOL = 5e-4                      # test_training_drift.py's bound
RERECORD_RTOL = 1e-6
B, STEPS, T_TOTAL, INIT_SEED, TRAIN_SEED = 8, 12, 100, 3, 4


def noise_shapes(cfg, b: int = B) -> dict:
    """The shape of each of NOISE_KEYS in one step of `cfg` at batch b."""
    g, l = cfg.group_num, cfg.num_patches
    kept = int((l + 1) * (1 - cfg.mae_vis_mask_ratio)) - 1
    return {"gumbel": (b, g, l), "gumbel_mae": (b, g, kept), "mask_vis": (b, l + 1),
            "mask_txt": (b, cfg.max_words)}


def record_trajectory() -> dict:
    """drift.run_trajectory() with its draws, init and batch recorded:
    {"sd/<name>": ..., "batch/<key>": ..., "noise/<key>": (STEPS, ...),
    "losses": (STEPS,)}, numpy."""
    by_shape = {shape: key for key, shape in noise_shapes(drift.TINY).items()}
    sink, steps, out = [], [], {}

    def recorded(draw):
        def fn(key, shape=(), *args, **kw):
            x = draw(key, shape, *args, **kw)
            jax.debug.callback(lambda v: sink.append(np.asarray(v)), x)
            return x
        return fn

    def create_train_state(cfg, params, **kw):
        jax.effects_barrier()
        sink.clear()                               # the init's draws
        out["config"] = np.asarray(json.dumps({
            "model": dataclasses.asdict(cfg.model), "optim": dataclasses.asdict(cfg.optim),
            "t_total": kw["t_total"], "seed": kw["seed"]}))
        out.update({f"sd/{k}": np.asarray(v, np.float32) for k, v in export_state_dict(
            jax.tree_util.tree_map(np.asarray, params),
            vision_patch_size=drift.TINY.vision_patch_size).items()})
        return real_create(cfg, params, **kw)

    def make_step(*args, **kw):
        step = real_make_step(*args, **kw)

        def run(state, batch):
            state, metrics = step(state, batch)
            jax.effects_barrier()
            draws = {by_shape[x.shape]: x for x in sink}
            assert len(sink) == len(draws) == len(NOISE_KEYS), [x.shape for x in sink]
            steps.append(draws)
            sink.clear()
            out.setdefault("batch", {k: np.asarray(v) for k, v in batch.items()})
            return state, metrics
        return run

    real_create, real_make_step = drift.create_train_state, drift.make_single_device_train_step
    with mock.patch.object(drift, "create_train_state", create_train_state), \
            mock.patch.object(drift, "make_single_device_train_step", make_step), \
            mock.patch("jax.random.gumbel", recorded(jax.random.gumbel)), \
            mock.patch("jax.random.uniform", recorded(jax.random.uniform)):
        losses = drift.run_trajectory(STEPS)
    out.update({f"batch/{k}": v for k, v in out.pop("batch").items()})
    out.update({f"noise/{k}": np.stack([s[k] for s in steps]) for k in NOISE_KEYS})
    out["losses"] = np.asarray(losses, np.float64)
    return out


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_fixture_parameters_are_the_jax_init(fixture):
    _, params = jax_init_segclip(drift.TINY, seed=INIT_SEED)
    sd = export_state_dict(jax.tree_util.tree_map(np.asarray, params),
                           vision_patch_size=drift.TINY.vision_patch_size)
    assert {f"sd/{k}" for k in sd} == {k for k in fixture if k.startswith("sd/")}
    for k, v in sd.items():
        np.testing.assert_array_equal(fixture[f"sd/{k}"], np.asarray(v, np.float32),
                                      err_msg=k)


def test_fixture_losses_are_the_golden_trajectory(fixture):
    np.testing.assert_allclose(fixture["losses"], drift.GOLDEN_LOSSES, rtol=RTOL)


def test_port_replays_the_jax_trajectory(fixture):
    """12 float32 steps of make_train_step from the fixture's init, on its
    batch, with JAX's draws of each step injected, through chip_smoke.py's
    own reader and replay (its phase 14 runs them on the card): each loss
    within rtol 5e-4 of JAX's, each step's attention and Gumbel shapes
    those phase 1 checks."""
    recorded = chip_smoke.drift_fixture(FIXTURE)
    cfg = port_config(drift.Config(model=drift.TINY, optim=drift.OptimConfig(
        lr=1e-3, lower_lr=1e-4)))
    assert dataclasses.asdict(recorded["cfg"]) == dataclasses.asdict(cfg)
    assert (recorded["t_total"], recorded["seed"]) == (T_TOTAL, TRAIN_SEED)
    shapes = noise_shapes(cfg.model)
    assert {k: tuple(v.shape[1:]) for k, v in recorded["noise"].items()} == shapes
    run = chip_smoke.drift_replay(torch.device("cpu"), recorded)
    assert not any(run["skipped"])
    np.testing.assert_allclose(run["loss"], fixture["losses"], rtol=RTOL)
    attn, gumbel = chip_smoke.step_shapes("drift", cfg.model, B)
    assert run["shapes"] == ({c[1:5] for c in attn}, {c[1:] for c in gumbel})


@pytest.mark.slow
def test_fixture_is_jax_run_recorded_again(fixture):
    fresh = record_trajectory()
    assert set(fresh) == set(fixture)
    for k, v in fresh.items():
        if k == "losses":
            np.testing.assert_allclose(v, fixture[k], rtol=RERECORD_RTOL)
        else:
            np.testing.assert_array_equal(v, fixture[k], err_msg=k)


if __name__ == "__main__":
    recorded = record_trajectory()
    np.savez_compressed(FIXTURE, **recorded)
    print(f"wrote {FIXTURE}; JAX's losses:")
    for x in recorded["losses"]:
        print(f"    {x:.10f},")

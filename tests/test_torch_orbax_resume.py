"""A JAX training run continued on the port through an Orbax checkpoint, on
the CPU, modelled on tests/test_torch_drift.py.

The JAX package takes two steps of the golden config (tests/
test_torch_train.py's TINY, its batches, its noise injected by patching
`jax.random.gumbel` and the JAX `random_masking`), saves them with its own
`save_checkpoint`, and takes step 3. The port restores the directory with
`orbax_io.restore_checkpoint` and takes step 3 on the same batch with the
same noise: its loss, and every parameter after it, within
test_torch_drift.py's rtol 5e-4 of JAX's step 3 (a parameter tensor to
5e-4 of its largest value: AdamW moves an element near zero by about lr
whatever its gradient, so an element-wise relative bound there measures
rounding, not the step). Both Adam moment dtypes are held.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from segclip_tpu.checkpoint.orbax_io import save_checkpoint as jax_save_checkpoint
from segclip_tpu.config import Config, OptimConfig
from segclip_tpu.models.segclip import SegCLIP as JSegCLIP
from segclip_tpu.models.segclip import init_segclip as jax_init_segclip
from segclip_tpu.train.step import create_train_state, make_single_device_train_step

from test_torch_train import (TINY, jax_noise, make_batch, make_noise, port_config,
                              torch_batch, torch_noise)

from segclip_tpu_torch.checkpoint import orbax_io
from segclip_tpu_torch.checkpoint.convert import state_dict_from_jax
from segclip_tpu_torch.models.segclip import SegCLIP
from segclip_tpu_torch.train.step import TrainState, create_optimizer, make_train_step

torch.set_num_threads(1)
RTOL = 5e-4                      # tests/test_torch_drift.py's bound
T_TOTAL = 100


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_port_continues_a_jax_run_from_its_orbax_checkpoint(tmp_path, moment_dtype):
    cfg = Config(model=TINY, optim=OptimConfig(lr=1e-3, lower_lr=1e-4,
                                               moment_dtype=moment_dtype))
    _, params = jax_init_segclip(TINY, seed=3)
    state, tx, trainable = create_train_state(cfg, params, t_total=T_TOTAL, seed=4)
    step = make_single_device_train_step(JSegCLIP(TINY), tx, trainable=trainable)
    batches = [make_batch(40 + i, uint8=True) for i in range(3)]
    noise = make_noise(41)
    losses = []
    with jax_noise(noise):
        for i, batch in enumerate(batches):
            if i == 2:
                path = jax_save_checkpoint(str(tmp_path), 1, state)
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(metrics["loss"]))

    model = SegCLIP(port_config(TINY))
    optimizer = create_optimizer(model, port_config(cfg), t_total=T_TOTAL)
    tstate, epoch = orbax_io.restore_checkpoint(path, model, optimizer, TrainState(seed=4))
    assert (epoch, tstate.step, optimizer.step_count) == (1, 2, 2)
    metrics = make_train_step(model, optimizer, port_config(cfg))(
        tstate, torch_batch(batches[2]), torch_noise(noise))
    assert not float(metrics["skipped_nan"]) and tstate.step == int(state.step) == 3
    np.testing.assert_allclose(float(metrics["loss"]), losses[2], rtol=RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                              TINY.vision_patch_size)
    got = model.state_dict()
    assert got.keys() == ref.keys()
    for name, want in ref.items():
        gap = (got[name] - want).abs().max().item()
        assert gap <= RTOL * max(want.abs().max().item(), 1e-12), (name, gap)
    moments = {p: m for p, m in optimizer.state.items()}
    assert moments and all(m["exp_avg"].dtype == optimizer.moment_dtype
                           for m in moments.values())
    assert dataclasses.asdict(port_config(cfg).optim)["moment_dtype"] == moment_dtype

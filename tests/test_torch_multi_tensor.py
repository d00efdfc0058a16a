"""The multi-tensor optimizer kernels' plan and dispatch on the CPU
(segclip_tpu_torch/ops/kernels/adamw.py, train/optimizer.py).

The kernels themselves (csrc/adamw.cu) run only on a card and are held to
the plain path there by tests/test_torch_kernels.py. Here: the constants
against the C source; the plan, walked block by block and thread by thread
the way the kernels index their chunks, covers every element of every leaf
exactly once at odd sizes; the update's launches take every trainable leaf
once, in group order, with its group's lr and weight decay and a null
gradient where a leaf has none; ViT-B/16's step is one launch of each
kernel; and CPU tensors take the plain path.
"""
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from segclip_tpu_torch.config import Config, ModelConfig, OptimConfig
from segclip_tpu_torch.models.segclip import SegCLIP, init_segclip
from segclip_tpu_torch.ops.kernels import adamw as kernels
from segclip_tpu_torch.train import optimizer as toptim
from segclip_tpu_torch.train.step import create_optimizer
from segclip_tpu_torch.utils import profiling

SRC = (Path(kernels.__file__).resolve().parents[2] / "csrc" / "adamw.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, VEC = constant("THREADS"), constant("VEC")
TINY = ModelConfig(image_resolution=32, vision_patch_size=8, vision_width=64, vision_layers=4,
                   first_stage_layer=3, group_num=4, cross_layer=1, context_length=16,
                   vocab_size=512, transformer_width=64, transformer_layers=2, embed_dim=32,
                   max_words=12, mae_decoder_depth=1, mae_decoder_num_heads=2,
                   compute_dtype="float32")
# Leaf sizes that put chunk and vector edges everywhere: one element, sizes
# off the vector width, a chunk less, exactly and more than one, none.
ODD = [1, 3, 4, 5, 7, 1023, 1025, kernels.CHUNK - 1, kernels.CHUNK, kernels.CHUNK + 1, 0,
       3 * kernels.CHUNK + 7, 2 * kernels.CHUNK + VEC * THREADS + 3]


def test_constants_match_the_c_source():
    for name in ("CHUNK", "MAX_LEAVES", "MAX_GROUPS"):
        assert constant(name) == getattr(kernels, name), name
    assert kernels.CHUNK % (VEC * THREADS) == 0


def touched(launch: kernels.Launch, numels: np.ndarray, vector: bool) -> dict:
    """How often each element of each leaf of the launch is touched, the way
    csrc/adamw.cu's kernels walk it: block b takes the last leaf whose first
    block is at most b and that leaf's chunk b − first; with every pointer
    aligned, thread t the VEC elements at lo + VEC·t + k·VEC·THREADS that
    end by hi, then the tail past the last whole VEC one element a thread;
    else element lo + t + k·THREADS."""
    first = launch.first
    hits = {int(i): np.zeros(numels[i], np.int64) for i in launch.leaves}
    for b in range(int(first[-1])):
        r = int(np.searchsorted(first[:-1], b, side="right")) - 1
        leaf = int(launch.leaves[r])
        lo = (b - int(first[r])) * kernels.CHUNK
        hi = min(lo + kernels.CHUNK, int(numels[leaf]))
        rest = lo
        if vector:
            starts = (lo + VEC * np.arange(THREADS)[:, None]
                      + VEC * THREADS * np.arange(kernels.CHUNK // (VEC * THREADS))[None])
            starts = starts[starts + VEC <= hi]
            for k in range(VEC):
                np.add.at(hits[leaf], starts + k, 1)
            rest = lo + (hi - lo) // VEC * VEC
        idx = rest + np.arange(THREADS)[:, None] + THREADS * np.arange(
            -(-(hi - rest) // THREADS) if hi > rest else 0)[None]
        np.add.at(hits[leaf], idx[idx < hi], 1)
    return hits


@pytest.mark.parametrize("vector", [True, False])
@pytest.mark.parametrize("numels, kinds", [
    (ODD, [(i % 2,) for i in range(len(ODD))]),
    ([(i * 37) % 300 + 1 for i in range(2 * kernels.MAX_LEAVES + 5)],
     [(0,)] * (2 * kernels.MAX_LEAVES + 5)),
    ([5, kernels.CHUNK + 1, 1, 0, 0, 9], [(0, 1, 0)] * 6)])
def test_plan_covers_every_element_once(numels, kinds, vector):
    numels = np.asarray(numels, np.int64)
    launches = kernels.plan(numels, kinds)
    seen = []
    for launch in launches:
        assert len(launch.leaves) <= kernels.MAX_LEAVES
        assert {kinds[i] for i in launch.leaves} == {launch.kind}
        assert launch.first.dtype == np.int32 and launch.first[0] == 0
        assert np.array_equal(np.diff(launch.first), -(-numels[launch.leaves] // kernels.CHUNK))
        for leaf, hits in touched(launch, numels, vector).items():
            assert (hits == 1).all(), (leaf, numels[leaf], np.flatnonzero(hits != 1)[:5])
        seen += launch.leaves.tolist()
    # no leaf twice, every leaf with elements once; each kind's leaves in
    # their order (one of no elements may ride along, owning no block)
    assert len(seen) == len(set(seen)) and {i for i, n in enumerate(numels) if n} <= set(seen)
    for kind in set(kinds):
        mine = [i for i in seen if kinds[i] == kind]
        assert mine == sorted(mine)
    assert kernels.plan([0, 0], [(0,), (0,)]) == []


def tiny_optimizer(moment_dtype="float32"):
    cfg = Config(model=TINY, optim=OptimConfig(lr=4e-3, lower_lr=4e-6, lower_text_lr=1e-6,
                                               freeze_layer_num=2, weight_decay=0.05,
                                               moment_dtype=moment_dtype))
    model = init_segclip(cfg.model, seed=0)
    return model, create_optimizer(model, cfg, t_total=10)


def test_update_launches_take_every_trainable_leaf_once_with_its_group():
    model, opt = tiny_optimizer()
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert len(trainable) < len(list(model.parameters()))     # frozen leaves are not in it
    assert len({(g["lr"], g["weight_decay"]) for g in opt.param_groups}) > 2
    no_grad = trainable[5]
    for p in trainable:
        if p is not no_grad:
            p.grad = torch.randn_like(p)
    group_of = {p: g for g in opt.param_groups for p in g["params"]}
    sched, bc1, bc2 = opt.schedule_factor(1), 1 - opt.b1, 1 - opt.b2
    leaves = opt.kernel_leaves()
    args = kernels.adamw_args(leaves, [g["lr"] * sched for g in opt.param_groups],
                              [g["weight_decay"] for g in opt.param_groups],
                              bc1, bc2, opt.b1, opt.b2, opt.eps)
    assert len(args) == len(leaves.launches) == 1
    order = []
    for launch, a in zip(leaves.launches, args):
        assert (a.p_dtype, a.m_dtype) == (0, 0) and a.n == len(launch.leaves)
        assert np.array_equal(a.first, launch.first)
        for row, i in enumerate(launch.leaves):
            p = leaves.params[i]
            state, group = opt.state[p], group_of[p]
            order.append(p)
            assert a.numel[row] == p.numel()
            assert a.ptrs[row].tolist() == [
                p.data_ptr(), 0 if p.grad is None else p.grad.data_ptr(),
                state["exp_avg"].data_ptr(), state["exp_avg_sq"].data_ptr()]
            lr_t = group["lr"] * sched
            assert a.lr[a.group[row]] == np.float32(lr_t)
            assert a.c2[a.group[row]] == np.float32(lr_t / bc1)
            assert a.wd[a.group[row]] == np.float32(group["weight_decay"])
        assert (a.b1, a.omb1, a.b2, a.omb2, a.eps) == (opt.b1, 1 - opt.b1, opt.b2, 1 - opt.b2,
                                                        opt.eps)
        assert a.inv_sqrt_bc2 == np.float32(1) / np.float32(np.sqrt(bc2))
    assert [id(p) for p in order] == [id(p) for g in opt.param_groups for p in g["params"]]
    assert {id(p) for p in order} == {id(p) for p in trainable}
    row = next(r for r, i in enumerate(leaves.launches[0].leaves) if leaves.params[i] is no_grad)
    assert args[0].ptrs[row, 1] == 0                                # a zero gradient


def test_update_leaves_follow_a_replaced_state():
    """load_state_dict replaces the moments (and the checkpoint loaders cast
    them afterwards): the leaves are rebuilt, and the addresses are read at
    every launch."""
    _, opt = tiny_optimizer()
    leaves = opt.kernel_leaves()
    assert opt.kernel_leaves() is leaves
    opt.load_state_dict(opt.state_dict())
    assert opt._leaves is None
    leaves = opt.kernel_leaves()
    p = leaves.params[0]
    opt.state[p]["exp_avg"] = opt.state[p]["exp_avg"].clone()
    assert leaves.pointers()[0, 2] == opt.state[p]["exp_avg"].data_ptr()
    opt.add_param_group({"params": [torch.nn.Parameter(torch.zeros(3))],
                         "param_names": ["extra"], "lr": 1.0, "weight_decay": 0.0})
    assert opt._leaves is None


def test_vit_b16_step_is_one_launch_of_each_kernel():
    """The benchmark's ViT-B/16 step (every block trained, as its traffic's
    optimizer sets): its trainable leaves make one update launch and one
    norm and scale launch each, so a step's clip and update are 4 launches."""
    cfg = Config(optim=OptimConfig(freeze_layer_num=0, freeze_text_layer_num=0))
    with torch.device("meta"):
        model = SegCLIP(cfg.model)
        opt = create_optimizer(model, cfg, t_total=100)
        trainable = [p for p in model.parameters() if p.requires_grad]
        grads = kernels.GradTable([torch.empty_like(p) for p in trainable])
    leaves = opt.kernel_leaves()
    assert len(leaves.params) == len(trainable) == 407
    assert sum(p.numel() for p in trainable) == 162_644_169
    assert len(leaves.launches) == len(grads.launches) == 1
    assert grads.blocks == leaves.launches[0].first[-1]


def test_grad_table_flags_dtypes_and_layouts():
    grads = [torch.zeros(5), torch.zeros(3, dtype=torch.bfloat16), torch.zeros(2)]
    table = kernels.GradTable(grads, [True, False, True])
    assert table.flag.tolist() == [1, 0, 1]
    assert [launch.kind for launch in table.launches] == [(0,), (1,)]
    assert [launch.leaves.tolist() for launch in table.launches] == [[0, 2], [1]]
    with pytest.raises(TypeError, match="float16"):
        kernels.GradTable([torch.zeros(4, dtype=torch.float16)])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.GradTable([torch.zeros(4, 4).t()])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.multi_tensor_norm(table, 1.0)


def test_update_pointers_refuse_a_gradient_the_kernel_cannot_read():
    """The update kernel reads each gradient as its parameter's dtype,
    contiguous: anything else raises when the addresses are read."""
    p = torch.nn.Parameter(torch.zeros(4, 4))
    state = {"exp_avg": torch.zeros(4, 4), "exp_avg_sq": torch.zeros(4, 4)}
    leaves = kernels.AdamWLeaves([p], [state], [0])
    assert leaves.pointers()[0, 1] == 0
    p.grad_dtype = None                 # torch allows a gradient of another dtype
    p.grad = torch.zeros(4, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 gradient of a torch.float32 parameter"):
        leaves.pointers()
    p.grad = torch.zeros(4, 4).t()
    with pytest.raises(ValueError, match="strided"):
        leaves.pointers()
    p.grad = torch.zeros(4, 4)
    assert leaves.pointers()[0, 1] == p.grad.data_ptr()
    for moment in (torch.zeros(4, 4).t(), torch.zeros(4, 4, dtype=torch.bfloat16),
                   torch.zeros(16)):
        state["exp_avg_sq"] = moment
        with pytest.raises((TypeError, ValueError), match="moments must|contiguous"):
            leaves.pointers()


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_loaded_moments_are_contiguous_in_moment_dtype(moment_dtype):
    """A checkpoint's moments may come as views of another layout (the
    Orbax reader's transposes) and in the parameters' dtype: loading makes
    them contiguous, in moment_dtype, with their values, and the update's
    leaves take them."""
    _, opt = tiny_optimizer(moment_dtype)
    opt.kernel_leaves()
    saved = opt.state_dict()
    strided = 0
    for state in saved["state"].values():
        for key in ("exp_avg", "exp_avg_sq"):
            t = torch.randn(state[key].shape)
            if t.dim() == 2:
                t, strided = t.t().contiguous().t(), strided + 1
            state[key] = t
    assert strided
    values = {i: {k: v.to(getattr(torch, moment_dtype)) for k, v in st.items()}
              for i, st in saved["state"].items()}
    opt.load_state_dict(saved)
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        for key in ("exp_avg", "exp_avg_sq"):
            t = opt.state[p][key]
            assert t.is_contiguous() and t.dtype == getattr(torch, moment_dtype)
            assert torch.equal(t, values[i][key])
    assert opt.kernel_leaves().pointers().shape == (len(params), 4)


def test_update_takes_at_most_max_groups():
    p = torch.nn.Parameter(torch.zeros(3))
    state = {"exp_avg": torch.zeros(3), "exp_avg_sq": torch.zeros(3)}
    assert kernels.AdamWLeaves([p], [state], [kernels.MAX_GROUPS - 1]).group.tolist() == [15]
    with pytest.raises(ValueError, match="at most 16 parameter groups"):
        kernels.AdamWLeaves([p], [state], [kernels.MAX_GROUPS])


def test_cpu_takes_the_plain_path():
    model, opt = tiny_optimizer()
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.grad = torch.randn_like(p)
    before = profiling.counters()
    with mock.patch.object(toptim, "global_norm_clip_plain",
                           wraps=toptim.global_norm_clip_plain) as clip, \
            mock.patch.object(toptim, "adamw_plain", wraps=toptim.adamw_plain) as update:
        norm = toptim.global_norm_clip(params, 1.0)
        opt.step()
    assert clip.call_count == update.call_count == 1 and norm.device.type == "cpu"
    after = profiling.counters()
    for name in ("multi_tensor_norm", "multi_tensor_scale", "multi_tensor_adamw"):
        assert after[f"{name}.launches"] == before[f"{name}.launches"], name

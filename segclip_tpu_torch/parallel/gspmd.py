"""Tensor parallelism over the data × model rank grid: the port's
segclip_tpu/parallel/gspmd.py.

The JAX package gets its dp × tp step from the compiler: the global-batch
program jitted with Megatron sharding annotations, XLA inserting the
collectives. Here it is explicit Megatron over torch.distributed groups,
not a compiler partitioner: the model's layers hold their slices of the
sharded parameters and call the two collectives below themselves; the data
column's collectives (parallel/collectives.py) stay those of the
data-parallel step. The step is the same global-batch program, so it
agrees with the 1-process step up to the order of floating-point sums.

Sharding rules (gspmd.py:13-21, 46-69), on the reference-layout names in
torch's (out, in) layout:
  attn in_proj_weight (3d, d), in_proj_bias  split by head inside each of
    (timm: attn.qkv.weight, .bias)           the q, k and v blocks: a rank
                                             keeps q[h0:h1] | k[h0:h1] |
                                             v[h0:h1], its heads whole
  attn out_proj.weight (d, d)                split along the input dim;
    (timm: attn.proj.weight)                 the bias replicated
  mlp c_fc / fc1 weight (h, d) and bias      split by rows
  mlp c_proj / fc2 weight (d, h)             split along the input dim;
                                             the bias replicated
  clip.token_embedding.weight (V, d)         split by vocabulary rows
  everything else                            replicated
As in JAX, a layer that does not divide stays replicated (logged once per
layer): here an attention whose head count, an MLP whose hidden width or a
vocabulary whose size tp does not divide. JAX splits an attention by its
width and lets the compiler move whole heads; explicit Megatron needs whole
heads on each rank, so its test is on heads.

Each sharded Parameter carries its `Shard` as `p.model_shard`; the clip
norm (train/optimizer.global_norm_clip) and `gather_state_dict` read it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from segclip_tpu_torch.parallel import dist
from segclip_tpu_torch.utils.logging import get_logger


class Shard(NamedTuple):
    """Split along `dim`; with blocks > 1, each of `blocks` equal blocks
    along `dim` is split on its own (the packed q | k | v)."""
    dim: int
    blocks: int = 1


_PACKED = ("attn.in_proj_weight", "attn.in_proj_bias", "attn.qkv.weight", "attn.qkv.bias")
_ATTN_OUT = ("attn.out_proj.weight", "attn.proj.weight")
_MLP_IN = ("mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.fc1.weight", "mlp.fc1.bias")
_MLP_OUT = ("mlp.c_proj.weight", "mlp.fc2.weight")
_VOCAB = "clip.token_embedding.weight"


def shard_spec(name: str, param: torch.Tensor, tp: int,
               heads: Optional[int] = None) -> Optional[Shard]:
    """The port's `_spec_for`: how the parameter `name` (reference layout)
    is split over tp model ranks, or None for replicated. `heads` is the
    owning attention's head count, required for attention parameters."""
    if tp == 1:
        return None
    if name.endswith(_PACKED + _ATTN_OUT):
        if heads is None:
            raise ValueError(f"{name}: the attention's head count is needed")
        if heads % tp:
            return None
        return Shard(0, 3) if name.endswith(_PACKED) else Shard(1)
    if name.endswith(_MLP_IN):
        return Shard(0) if param.shape[0] % tp == 0 else None
    if name.endswith(_MLP_OUT):
        return Shard(1) if param.shape[1] % tp == 0 else None
    if name == _VOCAB:
        return Shard(0) if param.shape[0] % tp == 0 else None
    return None


def _attention_heads(model: nn.Module) -> Dict[str, int]:
    """{parameter name: head count} of every attention's parameters."""
    heads = {}
    for mname, m in model.named_modules():
        if mname.endswith("attn") and hasattr(m, "heads"):
            for pname, _ in m.named_parameters():
                heads[f"{mname}.{pname}"] = m.heads
    return heads


def shard_specs(model: nn.Module, tp: int) -> Dict[str, Optional[Shard]]:
    """shard_spec of every parameter of the full (unsharded) model."""
    heads = _attention_heads(model)
    return {name: shard_spec(name, p, tp, heads.get(name))
            for name, p in model.named_parameters()}


def local_slice(full: torch.Tensor, spec: Shard, rank: int, tp: int) -> torch.Tensor:
    """Model rank `rank`'s slice of a full tensor."""
    blocks = full.chunk(spec.blocks, dim=spec.dim)
    return torch.cat([b.chunk(tp, dim=spec.dim)[rank] for b in blocks], dim=spec.dim)


def assemble(pieces, spec: Shard) -> torch.Tensor:
    """The full tensor from every model rank's slice, in model rank order
    (the inverse of `local_slice`)."""
    split = [p.chunk(spec.blocks, dim=spec.dim) for p in pieces]
    return torch.cat([s[b] for b in range(spec.blocks) for s in split], dim=spec.dim)


def _row() -> Tuple[object, int, int]:
    """This rank's model row: its group, this rank's index in it, its size.
    Raises when there is no grid (parallel/dist.init_grid with tp > 1)."""
    group = dist.model_group()
    if group is None:
        raise RuntimeError("tensor parallelism needs the data × model grid: "
                           "call parallel.dist.init_grid(tp) with tp > 1 first")
    return group, dist.model_rank(), dist.model_size()


def shard_model_(model: nn.Module) -> Dict[str, Optional[Shard]]:
    """Replace each sharded parameter of the full `model` by this rank's
    slice of it, in place, and set what the forward reads: the model row's
    group on each module that holds sharded parameters (an attention, an
    MLP, the token embedding; each has a `model_group` attribute), an
    attention's local head count and the embedding's first row. Returns the
    specs."""
    group, rank, tp = _row()
    specs = shard_specs(model, tp)
    modules = dict(model.named_modules())
    for name, spec in specs.items():
        if spec is None:
            continue
        mname, _, pname = name.rpartition(".")
        m = modules[mname]
        full = getattr(m, pname)
        local = nn.Parameter(local_slice(full.detach(), spec, rank, tp).clone(),
                             requires_grad=full.requires_grad)
        local.model_shard = spec
        setattr(m, pname, local)
    logger = get_logger()
    for mname, m in modules.items():
        if not hasattr(m, "model_group"):
            continue
        own = [s for n, s in specs.items() if n.startswith(f"{mname}.")]
        if not any(own):
            logger.info("tensor parallel: %s does not divide over %d model ranks; "
                        "replicated", mname, tp)
            continue
        m.model_group = group
        if hasattr(m, "heads"):
            m.heads //= tp
        if hasattr(m, "vocab_start"):
            m.vocab_start = rank * m.weight.shape[0]
    return specs


def _map_state(model: nn.Module, model_state: dict, optimizer_state: Optional[dict],
               fn) -> Tuple[dict, Optional[dict]]:
    """fn(tensor, its parameter's Shard) over every tensor of a sharded
    parameter in the two state dicts (the optimizer's moments found by the
    groups' `param_names`, train/param_groups.py); the rest kept."""
    sharded = {n: p.model_shard for n, p in model.named_parameters()
               if hasattr(p, "model_shard")}

    def one(name, t):
        spec = sharded.get(name)
        return t if spec is None or not t.dim() else fn(t, spec)

    model_out = {k: one(k, v) for k, v in model_state.items()}
    if optimizer_state is None:
        return model_out, None
    names = {}
    for group in optimizer_state["param_groups"]:
        names.update(zip(group["params"], group["param_names"]))
    state = {i: {k: one(names[i], v) for k, v in moments.items()}
             for i, moments in optimizer_state["state"].items()}
    return model_out, {**optimizer_state, "state": state}


def gather_state_dict(model: nn.Module, optimizer_state: Optional[dict] = None
                      ) -> Tuple[dict, Optional[dict]]:
    """The counterpart of `fetch_replicated` (gspmd.py:98-118): the full
    reference-layout state dict of a sharded model and, when given, the
    optimizer state dict with full moments, on every rank. A collective:
    every rank of the model row calls it."""
    group, _, _ = _row()
    model_state = {k: v.detach() for k, v in model.state_dict().items()}
    return _map_state(model, model_state, optimizer_state,
                      lambda t, spec: assemble(dist.all_gather(t, group), spec))


def shard_state_dict(model: nn.Module, model_state: dict,
                     optimizer_state: Optional[dict] = None
                     ) -> Tuple[dict, Optional[dict]]:
    """The inverse of `gather_state_dict`: this rank's slices of full state
    dicts, for the sharded `model` (resume, --init-model)."""
    _, rank, tp = _row()
    return _map_state(model, model_state, optimizer_state,
                      lambda t, spec: local_slice(t, spec, rank, tp).clone())


def model_group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: `t` summed over the model row. Counts the bytes it
    all-reduces in `model_group_sum.bytes`, the recompute's under remat
    too (models/layers.run_blocks: each block's attention all-reduce runs
    again in the backward, its MLP's does not)."""
    model_group_sum.bytes += t.numel() * t.element_size()
    out = t.to(dist.wire_device(), copy=True).contiguous()
    torch.distributed.all_reduce(out, group=group)
    return out.to(t.device)


model_group_sum.bytes = 0


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_group_sum(grad, ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return model_group_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward: before each projection split
    by rows, so the replicated input's gradient takes every rank's share."""
    return _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward: after each projection split
    along its input dim, before its replicated bias is added."""
    return _ReduceFromModelGroup.apply(x, group)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, start: int,
                             group) -> torch.Tensor:
    """The lookup of a table split by rows, this rank's rows starting at
    `start`: ids outside them read a zero row, and the sum over the model
    row gives each id its one row."""
    local = ids - start
    inside = (local >= 0) & (local < weight.shape[0])
    rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), weight)
    return reduce_from_model_group(rows * inside[..., None].to(rows.dtype), group)

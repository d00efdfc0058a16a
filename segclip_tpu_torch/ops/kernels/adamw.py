"""AdaptAdamW and the global-norm clip over many leaves at once: the CUDA
kernels of `csrc/adamw.cu`, the plan that cuts a list of leaves into their
launches, and the calls that launch them.

The optimizer (train/optimizer.py) takes these for CUDA tensors and its plain
loop of ATen ops (`adamw_plain`, `global_norm_clip_plain`, the kernels'
reference) for CPU ones. A step's clip and update are four launches at any
number of leaves up to MAX_LEAVES of one dtype: the norm's partial sums
(`multi_tensor_norm`, two launches with its finalize, three under tensor
parallelism), the scale (`multi_tensor_scale`) and the update
(`multi_tensor_adamw`); each counts its launches in `.launches`.

Each launch takes its table of leaves (addresses, sizes, a group or shard
flag, each leaf's first block) in the kernel's parameters, so nothing is
copied to the card before it and nothing waits for the card. `plan` gives
the launches: the leaves of one kind (the dtypes the kernel is built for)
in their order, MAX_LEAVES at a time, each leaf ⌈numel / CHUNK⌉ blocks of CHUNK
elements; a kernel's block finds its leaf as the last whose first block is
at most its own. The constants mirror the C source's (a CPU test reads them
there; `check_limits` asks the library).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from segclip_tpu_torch.kernels import build

CHUNK = 16384                   # elements a block
MAX_LEAVES = 512                # leaves a launch
MAX_GROUPS = 16                 # parameter groups a launch
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The finalize's output (float32): the replicated and the sharded sums of
# squares, the norm and the scale min(1, max_norm / (norm + 1e-6)).
SUM_REPLICATED, SUM_SHARDED, NORM, SCALE = range(4)


class Launch(NamedTuple):
    kind: tuple                 # what the kernel is built for, e.g. the dtypes' codes
    leaves: np.ndarray          # int64 indices into the caller's leaves, in order
    first: np.ndarray           # int32, len(leaves) + 1: each leaf's first block; [-1] the blocks


def plan(numels: Sequence[int], kinds: Sequence[tuple]) -> List[Launch]:
    """The launches that cover leaves of these sizes and kinds: the leaves
    of each kind, kinds in the order they first appear, in order and
    MAX_LEAVES at a time, each leaf ⌈numel / CHUNK⌉ blocks. A launch whose
    leaves have no elements is left out."""
    numels = np.asarray(numels, np.int64).reshape(-1)
    if len(kinds) != len(numels) or (numels < 0).any():
        raise ValueError("one kind and a size ≥ 0 for every leaf")
    blocks = -(-numels // CHUNK)
    by_kind: Dict[tuple, List[int]] = {}
    for i, kind in enumerate(kinds):
        by_kind.setdefault(kind, []).append(i)
    launches = []
    for kind, members in by_kind.items():
        for at in range(0, len(members), MAX_LEAVES):
            leaves = np.asarray(members[at:at + MAX_LEAVES], np.int64)
            first = np.zeros(len(leaves) + 1, np.int64)
            np.cumsum(blocks[leaves], out=first[1:])
            if first[-1] >= 2 ** 31:
                raise ValueError(f"{int(first[-1])} blocks exceed one launch's grid")
            if first[-1]:
                launches.append(Launch(kind, leaves, first.astype(np.int32)))
    return launches


def _device(tensors: Sequence[torch.Tensor]) -> torch.device:
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"the leaves must lie on one device, not {device} and others")
    return device


def _cuda(device: torch.device) -> torch.device:
    if device.type != "cuda":
        raise ValueError(f"the kernels launch on a CUDA card, not on {device}")
    return device


def _dtype(t: torch.Tensor) -> int:
    if t.dtype not in DTYPES:
        raise TypeError(f"the kernels take float32 or bfloat16 leaves, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("the kernels take contiguous leaves")
    return DTYPES[t.dtype]


def _addresses(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


class GradTable:
    """The clip's leaves: the gradients' addresses and sizes, each one's
    shard flag (1: a sharded leaf under tensor parallelism), and the
    launches that cover them. Built for each call: the gradients are new
    tensors every step."""

    def __init__(self, grads: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None):
        if not grads:
            raise ValueError("no gradients")
        self.device = _device(grads)
        kinds = [(_dtype(g),) for g in grads]
        self.ptrs = np.array([g.data_ptr() for g in grads], np.uint64)
        self.numel = np.array([g.numel() for g in grads], np.int64)
        self.flag = np.zeros(len(grads), np.uint8) if sharded is None else \
            np.asarray(sharded, np.uint8)
        if self.flag.shape != self.numel.shape:
            raise ValueError("one shard flag for every gradient")
        self.launches = plan(self.numel, kinds)
        self.blocks = sum(int(launch.first[-1]) for launch in self.launches)


class AdamWLeaves:
    """The update's leaves, in the optimizer's order: each parameter with
    its state (holding "exp_avg" and "exp_avg_sq") and its group's index,
    and the launches that cover them. Built once the state exists: the
    sizes, dtypes, groups and the moments' addresses are kept; each step
    (`pointers`) reads the parameters' and gradients' addresses anew, and a
    moment's where the state holds another tensor than before."""

    def __init__(self, params: Sequence[torch.Tensor], states: Sequence[dict],
                 groups: Sequence[int]):
        if not params or not len(params) == len(states) == len(groups):
            raise ValueError("one state and one group for every parameter, and one at least")
        self.params, self.states = list(params), list(states)
        self.moments = [(s["exp_avg"], s["exp_avg_sq"]) for s in states]
        self.device = _device([t for p, mv in zip(params, self.moments) for t in (p, *mv)])
        self.moment_dtypes = [m.dtype for m, _ in self.moments]
        self.rows = np.zeros((len(params), 4), np.uint64)   # p, g, m, v
        for i, (m, v) in enumerate(self.moments):
            self._take_moments(i, m, v)
        kinds = [(_dtype(p), _dtype(m)) for p, (m, _) in zip(params, self.moments)]
        self.numel = np.array([p.numel() for p in params], np.int64)
        groups = np.asarray(groups, np.int64)
        if groups.min() < 0 or groups.max() >= MAX_GROUPS:
            raise ValueError(f"the update takes at most {MAX_GROUPS} parameter groups")
        self.group = groups.astype(np.uint8)
        self.launches = plan(self.numel, kinds)

    def _take_moments(self, i: int, m: torch.Tensor, v: torch.Tensor) -> None:
        """Leaf i's moments from now on: of one dtype (the one the leaves
        were built with), the parameter's shape and contiguous."""
        if not (m.dtype == v.dtype == self.moment_dtypes[i]
                and m.shape == v.shape == self.params[i].shape):
            raise ValueError("a parameter's two moments must share its shape and the dtype "
                             "the update's leaves were built with")
        for t in (m, v):
            _dtype(t)                               # a dtype the kernel takes, contiguous
        self.moments[i] = (m, v)
        self.rows[i, 2:] = (m.data_ptr(), v.data_ptr())

    def pointers(self) -> np.ndarray:
        """(n, 4) uint64: each leaf's p, g, m and v now; g 0 where a leaf has
        no gradient (the update takes zeros). A gradient must have its
        parameter's dtype and be contiguous."""
        for i, (s, (m, v)) in enumerate(zip(self.states, self.moments)):
            if s["exp_avg"] is not m or s["exp_avg_sq"] is not v:
                self._take_moments(i, s["exp_avg"], s["exp_avg_sq"])
        grads = []
        for p in self.params:
            g = p.grad
            if g is not None and (g.dtype != p.dtype or not g.is_contiguous()):
                raise ValueError(f"the kernels take contiguous gradients of the parameter's "
                                 f"dtype, not a {'' if g.is_contiguous() else 'strided '}"
                                 f"{g.dtype} gradient of a {p.dtype} parameter")
            grads.append(0 if g is None else g.data_ptr())
        rows = self.rows.copy()
        rows[:, 0] = [p.data_ptr() for p in self.params]
        rows[:, 1] = grads
        return rows


@lru_cache(maxsize=None)
def _entries():
    lib = build.load()
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.segclip_grad_norm_partials.argtypes = [i, i, p, p, p, p, ll, ll, p, p]
    lib.segclip_grad_norm_finalize.argtypes = [p, ll, p, f, i, p]
    lib.segclip_grad_scale.argtypes = [i, i, p, p, p, p, p]
    lib.segclip_adamw.argtypes = [i, i, i, p, p, p, p, i, p, p, p] + [f] * 6 + [p]
    for fn in (lib.segclip_grad_norm_partials, lib.segclip_grad_norm_finalize,
               lib.segclip_grad_scale, lib.segclip_adamw):
        fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def check_limits() -> None:
    """Raise unless the library plans with CHUNK, MAX_LEAVES and MAX_GROUPS."""
    fn = build.load().segclip_adamw_limits
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)] * 3, None
    got = [ctypes.c_int() for _ in range(3)]
    fn(*map(ctypes.byref, got))
    if [g.value for g in got] != [CHUNK, MAX_LEAVES, MAX_GROUPS]:
        raise RuntimeError(f"csrc/adamw.cu plans with {[g.value for g in got]}, the wrapper "
                           f"with {[CHUNK, MAX_LEAVES, MAX_GROUPS]}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))


def multi_tensor_norm(table: GradTable, max_norm: float,
                      reduce_sharded: Optional[Callable[[torch.Tensor], object]] = None
                      ) -> torch.Tensor:
    """The global norm of the table's gradients and the clip's scale, on the
    card: out (4,) float32, [SUM_REPLICATED, SUM_SHARDED, NORM, SCALE].
    `reduce_sharded` (tensor parallelism) sums out[SUM_SHARDED] over the
    model row in place, between the sums and the norm."""
    device = _cuda(table.device)
    check_limits()
    lib = _entries()
    # no blocks (leaves of no elements): sums of 0, a norm of 0
    out = (torch.empty if table.blocks else torch.zeros)(4, dtype=torch.float32, device=device)
    part = torch.empty(2 * table.blocks, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream, offset = _stream(device), 0
        for launch in table.launches:
            ptrs, numel = table.ptrs[launch.leaves], table.numel[launch.leaves]
            flag = table.flag[launch.leaves]
            build.check(lib.segclip_grad_norm_partials(
                launch.kind[0], len(launch.leaves), _addresses(ptrs), _addresses(numel),
                _addresses(launch.first), _addresses(flag), offset, table.blocks,
                part.data_ptr(), stream), "multi_tensor_norm partials")
            offset += int(launch.first[-1])
            multi_tensor_norm.launches += 1
        finish = int(reduce_sharded is None)
        build.check(lib.segclip_grad_norm_finalize(part.data_ptr(), table.blocks, out.data_ptr(),
                                                   max_norm, finish, stream),
                    "multi_tensor_norm finalize")
        multi_tensor_norm.launches += 1
        if not finish:
            reduce_sharded(out[SUM_SHARDED])
            build.check(lib.segclip_grad_norm_finalize(part.data_ptr(), 0, out.data_ptr(),
                                                       max_norm, 1, stream),
                        "multi_tensor_norm finalize")
            multi_tensor_norm.launches += 1
    return out


def multi_tensor_scale(table: GradTable, out: torch.Tensor) -> None:
    """Every gradient of the table times out[SCALE] (rounded to its dtype),
    in place."""
    device = _cuda(table.device)
    check_limits()
    lib = _entries()
    with torch.cuda.device(device):
        stream = _stream(device)
        for launch in table.launches:
            ptrs, numel = table.ptrs[launch.leaves], table.numel[launch.leaves]
            build.check(lib.segclip_grad_scale(
                launch.kind[0], len(launch.leaves), _addresses(ptrs), _addresses(numel),
                _addresses(launch.first), out.data_ptr(), stream), "multi_tensor_scale")
            multi_tensor_scale.launches += 1


class AdamWArgs(NamedTuple):
    """One update launch's arguments to `segclip_adamw`, but the stream."""
    p_dtype: int
    m_dtype: int
    n: int
    ptrs: np.ndarray            # (n, 4) uint64: p, g (0: no gradient), m, v
    numel: np.ndarray           # int64 (n,)
    first: np.ndarray           # int32 (n + 1,)
    group: np.ndarray           # uint8 (n,): an index into lr, c2 and wd
    groups: int
    lr: np.ndarray              # float32 (groups,): lr_t
    c2: np.ndarray              # float32 (groups,): lr_t / bc1
    wd: np.ndarray              # float32 (groups,)
    b1: float
    omb1: float                 # 1 − b1, rounded from float64 as ATen rounds alpha
    b2: float
    omb2: float
    eps: float
    inv_sqrt_bc2: float         # float32 1 / float32 √bc2, as ATen divides by a scalar


def adamw_args(leaves: AdamWLeaves, lr_t: Sequence[float], weight_decay: Sequence[float],
               bc1: float, bc2: float, b1: float, b2: float, eps: float) -> List[AdamWArgs]:
    """The update's launches for this step: lr_t (each group's peak lr
    times the schedule) and weight_decay per parameter group, bc1 = 1 − b1^t
    and bc2 = 1 − b2^t, each constant rounded to float32 where the plain
    version's ATen ops round it; the addresses read now."""
    lr_t = np.asarray(lr_t, np.float64)
    lr32, c2 = lr_t.astype(np.float32), (lr_t / bc1).astype(np.float32)
    wd = np.asarray(weight_decay, np.float64).astype(np.float32)
    inv_sqrt_bc2 = float(np.float32(1.0) / np.float32(math.sqrt(bc2)))
    ptrs, out = leaves.pointers(), []
    for launch in leaves.launches:
        p_dtype, m_dtype = launch.kind
        out.append(AdamWArgs(p_dtype, m_dtype, len(launch.leaves), ptrs[launch.leaves],
                             leaves.numel[launch.leaves], launch.first,
                             leaves.group[launch.leaves], len(lr32), lr32, c2, wd,
                             b1, 1.0 - b1, b2, 1.0 - b2, eps, inv_sqrt_bc2))
    return out


def multi_tensor_adamw(leaves: AdamWLeaves, lr_t: Sequence[float], weight_decay: Sequence[float],
                       bc1: float, bc2: float, b1: float, b2: float, eps: float) -> None:
    """One AdaptAdamW step over the leaves, in place (`adamw_args`)."""
    device = _cuda(leaves.device)
    check_limits()
    lib = _entries()
    with torch.cuda.device(device):
        stream = _stream(device)
        for args in adamw_args(leaves, lr_t, weight_decay, bc1, bc2, b1, b2, eps):
            build.check(lib.segclip_adamw(*(_addresses(a) if isinstance(a, np.ndarray) else a
                                            for a in args), stream), "multi_tensor_adamw")
            multi_tensor_adamw.launches += 1
    torch.autograd.graph.increment_version(leaves.params)


multi_tensor_norm.launches = 0      # partial-sum and finalize launches
multi_tensor_scale.launches = 0
multi_tensor_adamw.launches = 0

"""Data and tensor parallelism over `torch.distributed` ranks (PyTorch port
of `emoasr_tpu/parallel/mesh.py`).

The JAX package runs one program over a `jax.sharding.Mesh`: batches split
over the `data` axis, and, where the mesh has a `model` axis, Megatron
tensor parallelism that GSPMD compiles from layout annotations.  Here every
rank is a process (started by `torchrun`) and the same two axes are made by
hand:

- `make_mesh(shape, axes)` lays the world's ranks out as JAX lays out its
  devices (rank = data index * model size + model index), fills in `-1`,
  and builds one process group per data column and per model row.
- `shard_batch` gives a rank its contiguous rows of the global batch, as
  `P("data")` splits them; a batch that the data axis does not divide
  raises, as `jax.device_put` does.
- The tensor-parallel layout of a model (which linear layers are split, on
  which dimension) is in `parallel/tensor.py`.
- Collectives: one flattened all-reduce of a micro-step's gradients over
  the data group; the two Megatron conjugate operators (`copy_to_model`:
  identity forward, all-reduce backward; `reduce_from_model`: the reverse);
  a differentiable all-reduce for the Conformer's BatchNorm statistics;
  for vocabulary-split logits (`parallel/vocab.py`) the log-sum-exp of the
  ranks' partial normalisers and a sum of partials, both gathered and
  combined in rank order (`model_logsumexp`, `model_sum_in_order`); the
  values that one rank owns and the others hold as 0 are summed by
  `reduce_from_model` (exact, so the same bits on every rank).
  Every collective is an `all_reduce` or a `broadcast`, the two that gloo
  takes for CUDA tensors, besides `all_gather_object` for decoded rows.

While a mesh is active (`make_mesh` activates it), the model's losses
divide by the global batch's rows or tokens (`global_rows`, `global_sum`),
and every random draw (dropout, SpecAugment, the fused attention's mask)
is made for the global batch and cut to the rank's rows and heads
(`rows_block`), so that a rank draws what one process draws for those rows.
Without a mesh, or on a mesh of one rank, every helper returns what the
single-process code computed before: a world of one takes today's path.

The backend comes from the device: `nccl` where each rank has a card of its
own, `gloo` on the CPU.  Ranks that share one card run over `gloo` only when
asked for it by name (`backend="gloo"`, or `EMOASR_DIST_BACKEND=gloo` for
the CLIs); NCCL refuses two ranks on one device, and nothing falls back.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

DATA, MODEL = "data", "model"
BACKEND_ENV = "EMOASR_DIST_BACKEND"


@dataclass
class Mesh:
    """This rank's place on the mesh and the groups it reduces over."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    rank: int
    world: int
    data_size: int
    data_rank: int
    model_size: int
    model_rank: int
    data_group: Optional[object]
    model_group: Optional[object]
    backend: Optional[str]
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_ACTIVE: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    """The mesh this process runs on, None in a single process."""
    return _ACTIVE


def set_active(mesh: Optional[Mesh]) -> None:
    global _ACTIVE
    _ACTIVE = mesh


def resolve_shape(shape: Sequence[int], axes: Sequence[str], world: int) -> Tuple[int, ...]:
    """Fill in `-1` from the world's size (JAX `make_mesh:21-38`); raise
    when the shape needs more ranks than exist.  A shape that leaves ranks
    idle raises too: every rank started must take part."""
    shape = [int(s) for s in shape]
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh_shape {tuple(shape)} and mesh_axes {axes} differ in length")
    if axes[0] != DATA or any(a not in (DATA, MODEL) for a in axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh_axes {axes}: the port's meshes are ('data',) and ('data', 'model')")
    if shape.count(-1) > 1:
        raise ValueError(f"mesh_shape {tuple(shape)}: at most one -1")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = world // known
    use = int(np.prod(shape))
    if use > world:
        raise ValueError(f"mesh_shape {tuple(shape)} ({axes}) needs {use} ranks, only {world} available")
    if use < world:
        raise ValueError(f"mesh_shape {tuple(shape)} ({axes}) uses {use} of {world} ranks: "
                         f"start as many ranks as the mesh has")
    return tuple(shape)


def pick_backend(device: torch.device, backend: Optional[str] = None,
                 local_world: int = 1) -> str:
    """`nccl` where every rank of the host has a card of its own, `gloo` on
    the CPU; `gloo` on shared cards only by name (see the module note)."""
    backend = backend or os.environ.get(BACKEND_ENV) or None
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: the CPU runs gloo")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    cards = torch.cuda.device_count()
    if cards < local_world:
        raise RuntimeError(
            f"{local_world} ranks on {cards} card(s): NCCL refuses two ranks on one device; "
            f"ask for gloo by name ({BACKEND_ENV}=gloo) to share a card")
    return "nccl"


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = (DATA,), *,
              device: Optional[torch.device] = None, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world: Optional[int] = None) -> Mesh:
    """Join (or start) the process group and lay its ranks out as a mesh.

    `rank`/`world`/`init_method` default to `torchrun`'s environment
    (`RANK`, `WORLD_SIZE`, `env://`).  `device` is the rank's device: the
    CPU, or a card (`cuda` picks `LOCAL_RANK`'s card under NCCL, the first
    card when ranks share it over gloo).  The rank's data and model
    coordinates, the groups and the backend are on the returned `Mesh`,
    which becomes the active one."""
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else int(world)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    device = torch.device("cpu" if device is None else device)
    shape = resolve_shape(shape, axes, world)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    chosen = pick_backend(device, backend, local_world)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local if chosen == "nccl" else 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(chosen, init_method=init_method or "env://", world_size=world, rank=rank)
    d = shape[0]
    m = shape[1] if len(shape) > 1 else 1
    data_group = model_group = None
    for j in range(m):  # every rank creates every group, in one order
        g = dist.new_group([i * m + j for i in range(d)])
        if rank % m == j:
            data_group = g
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)])
        if rank // m == i:
            model_group = g
    mesh = Mesh(shape=shape, axes=tuple(axes), rank=rank, world=world, data_size=d,
                data_rank=rank // m, model_size=m, model_rank=rank % m, data_group=data_group,
                model_group=model_group, backend=chosen, device=device)
    logging.info(describe(mesh))
    set_active(mesh)
    return mesh


def describe(mesh: Mesh) -> str:
    return (f"mesh {mesh.shape} {mesh.axes}: rank {mesh.rank} of {mesh.world} (data {mesh.data_rank}, "
            f"model {mesh.model_rank}) on {mesh.device} over {mesh.backend}")


def mesh_from_env(cfg, device: torch.device) -> Optional[Mesh]:
    """The trainers' and the eval CLI's mesh: None when the process was not
    started by `torchrun` (a world of one takes today's path), else the
    yaml's `mesh_shape` / `mesh_axes` over `torchrun`'s ranks."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return make_mesh(cfg.mesh_shape, cfg.mesh_axes, device=device)


def shutdown() -> None:
    """Leave the process group (the CLIs' last step on a mesh)."""
    set_active(None)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Rows of the global batch
# ---------------------------------------------------------------------------


def _split() -> Optional[Mesh]:
    """The active mesh when it splits the batch, else None."""
    m = _ACTIVE
    return m if m is not None and m.data_size > 1 else None


def row_slice(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of `n` rows (`P("data")`)."""
    if n % mesh.data_size:
        raise ValueError(
            f"a batch of {n} rows does not divide over the data axis of {mesh.data_size} ranks "
            f"(the JAX package's device_put refuses it too): pick batch sizes that divide")
    per = n // mesh.data_size
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(mesh: Optional[Mesh], batch: Dict) -> Dict:
    """A batch dict with its array leaves cut to this rank's rows;
    non-array fields (utt_ids, texts) pass through."""
    if mesh is None or mesh.data_size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        out[k] = v[row_slice(mesh, v.shape[0])] if isinstance(v, (np.ndarray, torch.Tensor)) else v
    return out


def global_rows(n: int) -> int:
    """The global batch's rows, for a rank that holds `n` of them."""
    m = _split()
    return n if m is None else n * m.data_size


def rows_block(n: int) -> Optional[Tuple[int, int]]:
    """(first row, global rows) of a rank's `n` rows; None without a split."""
    m = _split()
    return None if m is None else (m.data_rank * n, n * m.data_size)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()` of per-row values over the global batch: a rank's share
    (its rows' sum over the global rows)."""
    m = _split()
    return x.mean() if m is None else x.sum() / (x.numel() * m.data_size)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the data group."""
    m = _split()
    if m is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=m.data_group)
    return x


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce_flat_(tensors: List[torch.Tensor], group) -> None:
    """Sum `tensors` over `group` in place with one all-reduce of their
    concatenation (one dtype and device)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def reduce_metrics(mesh: Optional[Mesh], metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's share of the loss terms summed to the global ones (one
    all-reduce)."""
    if mesh is None or mesh.data_size == 1 or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    return {k: flat[i] for i, k in enumerate(keys)}


def all_reduce_(t: torch.Tensor, group) -> None:
    """`dist.all_reduce(t)` over `group` in place; a group object that
    carries its own `all_reduce` (threads of one process standing for the
    model ranks, as the CPU tests emulate them) is asked instead."""
    if hasattr(group, "all_reduce"):
        group.all_reduce(t)
    else:
        dist.all_reduce(t, group=group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (the
    input of a column-parallel product: each rank's share of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward (the partial outputs of a
    row-parallel product); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        all_reduce_(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group that every rank uses: all-reduce both ways."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        all_reduce_(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g, None


def gather_model(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """Every model rank's `x`, stacked in rank order, (size, *x.shape), on
    every rank (no gradient): one all-reduce of the zero-padded stack, which
    is exact (each entry has one non-zero term) and takes the CUDA tensors
    that gloo takes."""
    parts = x.new_zeros((size,) + tuple(x.shape))
    parts[rank].copy_(x)
    all_reduce_(parts, group)
    return parts


def lse_in_order(parts: torch.Tensor) -> torch.Tensor:
    """logsumexp over dimension 0, the exponentials summed in index order."""
    mx = parts.max(dim=0).values
    s = torch.exp(parts[0] - mx)
    for p in parts[1:]:
        s = s + torch.exp(p - mx)
    return mx + torch.log(s)


class _ModelLogSumExp(torch.autograd.Function):
    """The log-sum-exp of the model ranks' partial log-sum-exps (the vocabulary
    normaliser of split logits): gathered, then combined in rank order, so
    every rank holds the same bits.  Backward: this rank's share of the
    gradient, g exp(x - out), with no collective (what follows is
    replicated over the model group)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        out = lse_in_order(gather_model(x.contiguous(), group, rank, size))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out), None, None, None


class _ModelSumInOrder(torch.autograd.Function):
    """The sum of the model ranks' partials, gathered and added in rank
    order (the same bits on every rank); backward: identity."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        parts = gather_model(x.contiguous(), group, rank, size)
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def model_logsumexp(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    return _ModelLogSumExp.apply(x, group, rank, size)


def model_sum_in_order(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    return _ModelSumInOrder.apply(x, group, rank, size)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def batch_stats(h: torch.Tensor, dims: Tuple[int, ...]) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(mean, biased variance) of `h` over `dims` of the global batch, in
    float32 and differentiable (two all-reduces: the sum, then the squared
    deviations); None without a split, where the caller takes its own."""
    m = _split()
    if m is None:
        return None
    hf = h.float()
    n = float(np.prod([h.shape[d] for d in dims]) * m.data_size)
    mean = all_reduce_sum(hf.sum(dim=dims), m.data_group) / n
    shape = [1] * h.dim()
    for i in range(h.dim()):
        if i not in dims:
            shape[i] = h.shape[i]
    dev = hf - mean.reshape(shape)
    var = all_reduce_sum(dev.square().sum(dim=dims), m.data_group) / n
    return mean, var


# ---------------------------------------------------------------------------
# Random draws of the global batch
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, p: float, training: bool, shared: bool = False,
            split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """`F.dropout(x, p, training)` of a rank's rows (dimension 0; `shared`:
    a tensor that every row shares) and, with `split=(dim, first, total)`,
    its columns first.. of `total` on dimension `dim` (tensor parallelism):
    the mask of the global tensor is drawn from PyTorch's generator as one
    process draws it for `F.dropout` of the whole tensor, and cut to the
    rank's block."""
    m = _ACTIVE
    rows = m is not None and m.data_size > 1 and not shared
    if not training or p == 0.0 or not (rows or split is not None):
        return F.dropout(x, p, training)
    shape = list(x.shape)
    index = [slice(None)] * x.dim()
    if rows:
        n = shape[0]
        shape[0] = n * m.data_size
        index[0] = slice(m.data_rank * n, (m.data_rank + 1) * n)
    if split is not None:
        dim, first, total = split
        index[dim] = slice(first, first + shape[dim])
        shape[dim] = total
    noise = F.dropout(_ones_laid_out_as(x, shape), p, True)[tuple(index)]
    if x.dtype == torch.float32 or x.device.type == "cpu":  # the noise one process multiplies by
        return x * noise
    # a half dtype on the card, whose fused kernel scales in float32
    return torch.where(noise != 0, (x.float() * (1.0 / (1.0 - p))).to(x.dtype), torch.zeros_like(x))


def _ones_laid_out_as(x: torch.Tensor, shape) -> torch.Tensor:
    """Ones of `shape` in `x`'s memory order (`F.dropout` draws its mask in
    the memory order of its input: a transposed activation's mask is not a
    contiguous one's)."""
    order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    ones = torch.ones([shape[d] for d in order], dtype=x.dtype, device=x.device)
    return ones.permute([order.index(d) for d in range(x.dim())])


class Dropout(torch.nn.Dropout):
    """`nn.Dropout` that draws the global batch's mask (`dropout`); the
    tensor-parallel layout gives it the dimension it splits."""

    def __init__(self, p: float = 0.5, split: Optional[Tuple[int, int, int]] = None):
        super().__init__(p)
        self.split = split

    def forward(self, x):
        return dropout(x, self.p, self.training, split=self.split)


def gather_rows(mesh: Mesh, obj) -> Optional[list]:
    """Every rank's `obj` on rank 0 (in rank order), None elsewhere."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj)
    return out if mesh.is_main else None


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier()

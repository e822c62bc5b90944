"""Data and model parallelism over ``torch.distributed`` (counterpart of
geoguessr_ai_tpu/parallel/mesh.py).

The JAX package lays its devices out as one ``jax.sharding.Mesh`` with a
``data`` axis (the batch sharded, gradients all-reduced: the reference's
Accelerate DDP) and a ``model`` axis (the cell layer and the ViT
projections sharded), and lets GSPMD insert the collectives.  The port
keeps the layout and writes the collectives itself:

* **A JAX device is a torch rank.**  One process per card, started
  ``torchrun``-style (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``, or an explicit ``init_method``); the
  rank drives ``cuda:LOCAL_RANK`` and no other card (``Mesh.check_device``
  raises on a tensor of another).  The Hopper launchers keep their
  shared-memory opt-in in function-local statics, one process and one
  device each, so a second card in the process would find them set for
  the first.
* **A JAX slice (ICI) is a node (NVLink)**, a JAX DCN link the network
  between nodes: ``dcn_aware_order`` keeps each model-axis group inside
  one node, by the rank's node index (``rank // LOCAL_WORLD_SIZE``) where
  JAX reads ``slice_index``.
* **A JAX process is a torch rank** for ``host_shard_range``: each rank
  reads its own contiguous, disjoint rows, and the ranks' rows together
  cover every row.

Mesh positions: the ranks in ``dcn_aware_order`` reshaped (dp, mp); rank
(d, m) sits in data group m (the ranks of every data index at model index
m) and model group d.

**The data axis** (``batch_slice``, the counterpart of ``batch_sharding``;
a replicated value needs no call: every rank holds all of it): each rank
runs its rows of the global batch and the gradients are averaged over the
data group, which equals the JAX step on the global batch when the slices
are equal.  What reads the whole batch reads it whole: BatchNorm's train
statistics are all-reduced over the data group (differentiably, so the
backward sees the global statistics too, and the running statistics stay
equal on every rank), per-sample random masks are drawn for the global
batch and sliced (``rand_rows``), the contrastive loss gathers both
embeddings (``gather_data``), and the metrics gather logits and
coordinates (``gather_rows``).

**The model axis** (``param_spec``: the JAX name rules on the port's
names; a flax kernel is (in, out) and a ``Linear.weight`` (out, in), so a
flax column-sharded kernel is weight dim 0 and a row-sharded one dim 1;
column sharding also shards the bias):

* split in compute: the cell layer (column-parallel, its logits gathered
  before the haversine-smoothed loss, which needs every cell's
  logsumexp) and the MLP's ``fc1`` / ``fc2`` (a Megatron pair: the hidden
  units split, the partial products all-reduced in f32);
* stored sharded only: ``qkv`` / ``proj`` of the attention, gathered
  before each use, as XLA gathers operands around a custom call it cannot
  partition (the K1, K2 and K3 launches take whole weights).

Only the modules that declare a layer in ``MODEL_AXIS`` run it sharded;
``shard_module_`` raises on any other layer the rules would shard (CLIP's
``*_proj``).  Numerics equal the one-device step either way, up to the
order of sums.

Every collective is an all-reduce (sum): the one that both NCCL and gloo
carry on CUDA tensors, so that two ranks sharing one card (gloo, which
carries only broadcast and all-reduce there) run the same code as two
cards (NCCL).  A gather is the sum of zero-filled slots, one a rank, which
is exact.  Nothing falls back to a host copy.

Ranks on one machine without ``torchrun`` (the CPU tests over gloo, two
ranks sharing one card): ``spawn_ranks`` starts them with
``torch.multiprocessing`` and forms their group at a ``file://`` address.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from geoguessr_ai_torch.config import MeshConfig

#: Seconds a collective or the group's set-up waits for the other ranks.
TIMEOUT_S = 600


def maybe_initialize_distributed(backend: str = "nccl",
                                 init_method: Optional[str] = None) -> int:
    """Forms the process group of a multi-process run and returns its
    size.  A no-op returning 1 when ``WORLD_SIZE`` asks for one process
    (or is unset), and the group's size when it exists already.  Otherwise
    ``init_process_group(backend)`` at ``init_method`` (default
    ``env://``: ``MASTER_ADDR`` / ``MASTER_PORT``) as ``RANK`` of
    ``WORLD_SIZE``; any failure raises.  ``backend``: "nccl" on the card,
    "gloo" on the CPU or for ranks sharing one card; it is never chosen by
    detection."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1
    if "RANK" not in os.environ:
        raise ValueError(f"WORLD_SIZE={world} without RANK: start one "
                         "process per card with torchrun, or set RANK")
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]), world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return world


def _rank_and_world(rank: Optional[int], world: Optional[int]):
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return rank, world


def host_shard_range(total: int, rank: Optional[int] = None,
                     world: Optional[int] = None) -> tuple:
    """[start, stop) of the rows rank ``rank`` of ``world`` owns of a
    length-``total`` dataset (default: this process's rank and the group's
    size): ceil(total / world) rows a rank, the last ones short or
    empty."""
    i, n = _rank_and_world(rank, world)
    per = (total + n - 1) // n
    return min(i * per, total), min((i + 1) * per, total)


class Rank(NamedTuple):
    """A rank and the node it runs on (the JAX device's slice)."""

    rank: int
    node: int


def dcn_aware_order(devices: Sequence, model_parallel: int) -> list:
    """Orders ``devices`` (anything with a ``node`` attribute, such as
    ``Rank``) so that reshape(dp, mp) keeps every model-axis row inside
    one node: the per-matmul collectives stay on NVLink and only the data
    axis's per-step gradient all-reduce crosses nodes.  One node passes
    through unchanged; raises when the model axis cannot avoid crossing."""
    nodes = {getattr(d, "node", 0) for d in devices}
    if len(nodes) <= 1 or model_parallel <= 1:
        return list(devices)
    per_node: dict = {}
    for d in devices:
        per_node.setdefault(getattr(d, "node", 0), []).append(d)
    sizes = {len(v) for v in per_node.values()}
    if len(sizes) == 1 and next(iter(sizes)) % model_parallel == 0:
        return [d for n in sorted(per_node) for d in per_node[n]]
    raise ValueError(
        f"model_parallel={model_parallel} does not divide the per-node "
        f"rank counts {sorted(sizes)}: a model axis crossing nodes would "
        "put per-matmul collectives on the network between them (the DCN "
        "of a TPU pod)")


def mesh_shape(cfg: MeshConfig, world: int) -> tuple:
    """(dp, mp) of ``cfg`` over ``world`` ranks: data_parallel -1 takes
    every rank the model axis leaves.  Raises ValueError when dp * mp is
    not ``world``."""
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} does not cover {world} devices")
    return dp, mp


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype its collective runs in: floats below f32 go in
    f32 (their values exactly; sums rounded once)."""
    if t.is_floating_point() and t.element_size() < 4:
        return t.float()
    return t


@dataclasses.dataclass
class Mesh:
    """This rank's place on a (data, model) mesh and its two groups (None
    where the axis has one rank)."""

    dp: int
    mp: int
    rank: int
    data_index: int
    model_index: int
    data_group: Optional[object]
    model_group: Optional[object]
    device: torch.device
    #: parameter name -> (its sharded dim, the dim's whole size), filled by
    #: ``shard_module_``
    sharded: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def check_device(self, t: torch.Tensor) -> None:
        """Raises unless ``t`` lies on this rank's device."""
        if t.device != self.device:
            raise ValueError(
                f"rank {self.rank} drives {self.device}; a tensor on "
                f"{t.device} would make it drive a second device")

    # -- collectives -----------------------------------------------------

    def barrier(self) -> None:
        """Returns once every rank of the group has called it, on every
        backend: an all-reduce on this rank's device read back to the host
        (NCCL returns from a collective once it is queued on the stream;
        reading its result waits for every rank's part)."""
        if self.size > 1:
            t = torch.zeros((), device=self.device)
            dist.all_reduce(t)
            t.item()

    def _sum_(self, t: torch.Tensor, group) -> torch.Tensor:
        dist.all_reduce(t, group=group)
        return t

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data group of ``t`` (no gradient)."""
        if self.dp == 1:
            return t
        w = _wire(t.detach()).clone()
        return (self._sum_(w, self.data_group) / self.dp).to(t.dtype)

    def average_gradients(self, grads: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """Each gradient averaged over the data group, in f32, in one
        all-reduce of their concatenation."""
        if self.dp == 1:
            return list(grads)
        flat = torch.cat([g.detach().float().reshape(-1) for g in grads])
        self._sum_(flat, self.data_group).div_(self.dp)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t`` (no gradient), in rank order;
        the ranks may hold different counts (each slot padded to the
        largest, the counts gathered first)."""
        if self.dp == 1:
            return t
        counts = torch.zeros(self.dp, dtype=torch.float32, device=t.device)
        counts[self.data_index] = t.shape[0]
        self._sum_(counts, self.data_group)
        n = [int(c) for c in counts.tolist()]
        w = _wire(t.detach())
        slots = w.new_zeros((self.dp, max(n)) + tuple(t.shape[1:]))
        slots[self.data_index, :t.shape[0]] = w
        self._sum_(slots, self.data_group)
        return torch.cat([slots[i, :n[i]] for i in range(self.dp)]
                         ).to(t.dtype)

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t`` (equal counts), in rank order,
        differentiably, for a loss every rank takes of the whole batch:
        the backward sums the ranks' gradients and keeps this rank's rows,
        so that averaging the parameter gradients over the data group
        gives the global loss's gradient."""
        if self.dp == 1:
            return t
        return _GatherData.apply(t, self)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel layer: the identity, whose
        backward sums the model ranks' partial input gradients."""
        return x if self.mp == 1 else _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group of a row-parallel layer's partial
        products (in f32), whose backward is the identity."""
        return x if self.mp == 1 else _ReduceFromModel.apply(x, self)

    def gather_model(self, x: torch.Tensor, dim: int,
                     size: int) -> torch.Tensor:
        """The model ranks' shards of ``x`` joined along ``dim`` and cut to
        ``size`` (the last shard's padding dropped); the backward keeps
        this rank's shard of the gradient (every model rank computes the
        same loss from the whole tensor)."""
        if self.mp == 1:
            return x
        return _GatherModel.apply(x, self, dim, size)

    # -- parameters ------------------------------------------------------

    def global_norm(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares over the whole tensors behind
        ``named``: the sharded ones' local sums added over the model
        group, the replicated ones counted once."""
        rep = [t for n, t in named.items() if n not in self.sharded]
        if self.mp == 1 or len(rep) == len(named):
            return torch.sqrt(sum((t.float() ** 2).sum()
                                  for t in named.values()))
        sq = sum((t.float() ** 2).sum() for n, t in named.items()
                 if n in self.sharded)
        sq = self._sum_(sq.detach().clone(), self.model_group)
        return torch.sqrt(sum((t.float() ** 2).sum() for t in rep) + sq)

    def unshard(self, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """``tensors`` with each sharded entry joined from the model
        ranks' shards (a collective: every rank calls it)."""
        out = dict(tensors)
        for name, (dim, size) in self.sharded.items():
            if name in out:
                out[name] = _gather_slots(out[name].detach(),
                                          self.model_group, self.mp,
                                          self.model_index, dim, size)
        return out

    def shard(self, tensors: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """``tensors`` (whole) with each sharded entry cut to this rank's
        shard."""
        out = dict(tensors)
        for name, (dim, _) in self.sharded.items():
            if name in out:
                out[name] = _shard_of(out[name], self.mp, self.model_index,
                                      dim)
        return out

    # -- rows ------------------------------------------------------------

    def batch_rows(self, batch_size: int, grad_accum_steps: int = 1
                   ) -> np.ndarray:
        """The rows of a global batch this rank runs, in the order its
        step reads them: for each of the ``grad_accum_steps`` microbatches
        (rows [i m, (i + 1) m) of the global batch, as the JAX step splits
        it before sharding), this data index's equal share of it."""
        k = max(1, grad_accum_steps)
        if batch_size % (k * self.dp):
            raise ValueError(
                f"batch size {batch_size} does not split into "
                f"{k} microbatches of {self.dp} equal data shards")
        m = batch_size // k
        share = m // self.dp
        lo = self.data_index * share
        return np.concatenate([np.arange(i * m + lo, i * m + lo + share)
                               for i in range(k)])

    def eval_rows(self, batch_size: int) -> np.ndarray:
        """This data index's rows of an evaluation batch: contiguous, the
        counts differing by at most one (``gather_rows`` takes ragged
        shards); every rank gets one at least."""
        if batch_size < self.dp:
            raise ValueError(f"an evaluation batch of {batch_size} gives "
                             f"{self.dp} data ranks no row each")
        return np.array_split(np.arange(batch_size), self.dp)[self.data_index]


def _gather_slots(t, group, n, index, dim, size=None):
    """The n ranks' equal shards of ``t`` joined along ``dim`` (each
    rank's shard summed into its zero-filled slot), cut to ``size``."""
    w = _wire(t)
    slots = w.new_zeros((n,) + tuple(t.shape))
    slots[index] = w
    dist.all_reduce(slots, group=group)
    whole = torch.cat(slots.unbind(0), dim=dim)
    if size is not None:
        whole = whole.narrow(dim, 0, size)
    return whole.to(t.dtype)


def _shard_of(t, n, index, dim):
    """Rank ``index``'s shard of ``t`` along ``dim``: ceil(size / n) of it,
    the last shards padded with zeros (a zero row of a column-parallel
    layer gives a zero output, which the gather cuts off or the
    row-parallel layer after it multiplies by its own zero column)."""
    per = -(-t.shape[dim] // n)
    lo = min(index * per, t.shape[dim])
    part = t.narrow(dim, lo, min(per, t.shape[dim] - lo))
    if part.shape[dim] == per:
        return part.clone()
    pad = list(t.shape)
    pad[dim] = per - part.shape[dim]
    return torch.cat([part, t.new_zeros(pad)], dim)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _gather_slots(t, mesh.data_group, mesh.dp, mesh.data_index, 0)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        w = _wire(g.contiguous()).clone()
        dist.all_reduce(w, group=mesh.data_group)
        return w.chunk(mesh.dp, 0)[mesh.data_index].to(g.dtype), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        w = _wire(g.contiguous()).clone()
        dist.all_reduce(w, group=ctx.mesh.model_group)
        return w.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        w = _wire(x.contiguous()).clone()
        dist.all_reduce(w, group=mesh.model_group)
        return w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, size):
        ctx.mesh, ctx.dim = mesh, dim % x.ndim
        return _gather_slots(x, mesh.model_group, mesh.mp, mesh.model_index,
                             dim, size)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return (_shard_of(g, mesh.mp, mesh.model_index, ctx.dim),
                None, None, None)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        w = t.clone()
        dist.all_reduce(w, group=group)
        return w

    @staticmethod
    def backward(ctx, g):
        w = g.clone()
        dist.all_reduce(w, group=ctx.group)
        return w, None


def all_reduce_sum(t: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
    """The sum of ``t`` over the data group, differentiably: the backward
    sums the ranks' gradients, as ``torch.distributed.nn.functional.
    all_reduce`` does (deprecated in torch 2.13)."""
    return _AllReduceSum.apply(t, mesh.data_group)


def rand_rows(shape: Sequence[int], generator: torch.Generator,
              mesh: Optional["Mesh"] = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` where ``shape[0]`` counts
    this rank's rows: on a data axis the draw covers every data rank's
    rows (so the generator advances as one process's on the global batch)
    and this rank's slice is returned."""
    if mesh is None or mesh.dp == 1:
        return torch.rand(tuple(shape), generator=generator,
                          device=generator.device)
    n = shape[0]
    full = torch.rand((n * mesh.dp,) + tuple(shape[1:]), generator=generator,
                      device=generator.device)
    return full[mesh.data_index * n:(mesh.data_index + 1) * n]


def create_mesh(cfg: MeshConfig = MeshConfig(), world: Optional[int] = None,
                device=None) -> Mesh:
    """This rank's place on the (data, model) mesh of ``cfg`` over the
    process group (``world`` ranks; default the group's size, 1 without
    one), with its two groups formed (every rank must call this, in the
    same order).  ``device``: this rank's device (default
    ``cuda:LOCAL_RANK``, made current).  Raises ValueError when the mesh
    does not cover the ranks."""
    rank, world = _rank_and_world(None, world)
    dp, mp = mesh_shape(cfg, world)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    order = dcn_aware_order([Rank(r, r // per_node) for r in range(world)],
                            mp)
    grid = np.asarray([r.rank for r in order]).reshape(dp, mp)
    d, m = (int(i[0]) for i in np.nonzero(grid == rank))
    data_group = model_group = None
    if world > 1:
        # every rank forms every group, in one order
        if dp > 1:
            for j in range(mp):
                g = _group(grid[:, j])
                if j == m:
                    data_group = g
        if mp > 1:
            for i in range(dp):
                g = _group(grid[i])
                if i == d:
                    model_group = g
    return Mesh(dp, mp, rank, d, m, data_group, model_group, device)


#: The groups formed in this process group, by their ranks (and the
#: process group they belong to under "world").
_GROUPS: dict = {}


def _group(ranks) -> object:
    """The group of ``ranks``, formed once a process group: every mesh
    over the same ranks shares it (``dist.new_group`` is a collective of
    every rank and, on NCCL, a communicator holding device memory).  The
    ranks form their meshes in one order, so their caches agree."""
    if _GROUPS.get("world") is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD
    key = tuple(int(r) for r in ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def mesh_for(cfg: MeshConfig, device=None) -> Optional[Mesh]:
    """The mesh of ``cfg`` for this process on ``device`` (None: the card,
    ``cuda:LOCAL_RANK``), or None when it is one device: forms the process
    group first when ``WORLD_SIZE`` asks for several processes (gloo on
    the CPU, NCCL on the card).  Raises ValueError when the mesh does not
    cover the processes."""
    device = None if device is None else torch.device(device)
    cpu = device is not None and device.type == "cpu"
    world = maybe_initialize_distributed("gloo" if cpu else "nccl")
    if world == 1:
        mesh_shape(cfg, 1)
        return None
    if device is not None and device.type == "cuda" and device.index is None:
        device = None  # cuda:LOCAL_RANK
    return create_mesh(cfg, world, device)


def batch_slice(global_batch: Dict, mesh: Optional[Mesh],
                grad_accum_steps: int = 1) -> Dict:
    """This rank's rows (``Mesh.batch_rows``) of every array and tensor of
    a global batch; other entries as they are.  The identity without a
    mesh."""
    if mesh is None:
        return global_batch
    n = next(len(v) for v in global_batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)))
    rows = mesh.batch_rows(n, grad_accum_steps)
    out = {}
    for k, v in global_batch.items():
        if isinstance(v, torch.Tensor):
            v = v[torch.as_tensor(rows, device=v.device)]
        elif isinstance(v, np.ndarray):
            v = v[rows]
        out[k] = v
    return out


# Layers whose weights are column-sharded on the model axis (the JAX
# package's rule on flax names; a name matches exactly or as a suffix).
_COL_SHARDED = ("cell_layer", "qkv", "fc1", "mlp_fc1")
_ROW_SHARDED = ("proj", "fc2", "mlp_fc2")


def param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dim of parameter ``name`` (a state-dict name such as
    "backbone.stage1_block0.attn.qkv.weight") sharded on the model axis,
    or None (replicated).  The JAX rule, transposed: a column-parallel
    layer's weight shards dim 0 (flax's last) and its bias too; a
    row-parallel layer's weight shards dim 1 (flax's first) and its bias
    not at all."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    owner, leaf = parts[-2], parts[-1]

    def match(names):
        return any(owner == k or owner.endswith(k) for k in names)

    col, row = match(_COL_SHARDED), match(_ROW_SHARDED)
    if leaf == "weight" and tensor.ndim >= 2:
        if col:
            return 0
        if row:
            if tensor.ndim != 2:
                raise ValueError(f"{name}: a row-sharded weight of "
                                 f"{tensor.ndim} dims")
            return 1
    if leaf == "bias" and col:
        return 0
    return None


def shard_module_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Puts ``model`` on ``mesh`` in place (the counterpart of
    ``put_variables``): every module that reads the batch whole (one that
    declares a ``mesh`` attribute: BatchNorm, DropPath, the positional
    encoder's dropout) gets the mesh, and on a model axis every parameter
    ``param_spec`` shards keeps only this rank's shard (its Linear gets
    ``mesh`` and ``mesh_dim``, and ``mesh.sharded`` its name).  A dim that
    does not split evenly (12647 cells over two ranks) gets ceil(size / mp)
    a rank, the last shard padded with zeros.  Raises NotImplementedError
    for a layer the rules shard whose parent does not run it sharded (its
    ``MODEL_AXIS``)."""
    for mod in model.modules():
        if "mesh" in type(mod).__dict__:
            mod.mesh = mesh
    if mesh.mp == 1:
        return model
    for parent_name, parent in model.named_modules():
        for attr, child in parent.named_children():
            if not isinstance(child, nn.Linear):
                continue
            full = f"{parent_name}.{attr}" if parent_name else attr
            dims = {p: param_spec(f"{full}.{p}", t)
                    for p, t in child.named_parameters(recurse=False)}
            if all(d is None for d in dims.values()):
                continue
            if attr not in getattr(type(parent), "MODEL_AXIS", ()):
                raise NotImplementedError(
                    f"{full}: the model axis runs the cell layer and "
                    "TinyViT's qkv, proj, fc1 and fc2 sharded; "
                    f"{type(parent).__name__} does not run {attr} sharded")
            for p, d in dims.items():
                if d is None:
                    continue
                t = getattr(child, p)
                mesh.sharded[f"{full}.{p}"] = (d, t.shape[d])
                t.data = _shard_of(t.data, mesh.mp, mesh.model_index, d)
            child.mesh = mesh
            child.mesh_dim = dims["weight"]
    return model


class Dense(NamedTuple):
    """A Linear's whole weight and bias."""

    weight: torch.Tensor
    bias: Optional[torch.Tensor]


def whole(lin: nn.Linear):
    """``lin`` itself, or for a Linear stored sharded a ``Dense`` of its
    weight and bias gathered from the model ranks (differentiably)."""
    mesh = getattr(lin, "mesh", None)
    if mesh is None:
        return lin
    d = lin.mesh_dim
    size = (lin.out_features, lin.in_features)[d]
    bias = lin.bias
    if bias is not None and d == 0:
        bias = mesh.gather_model(bias, 0, size)
    return Dense(mesh.gather_model(lin.weight, d, size), bias)


def _rank_main(rank: int, fn: Callable, world: int, init_method: str,
               backend: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    maybe_initialize_distributed(backend, init_method)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, init_method: str,
                args: Sequence = (), backend: str = "gloo",
                timeout: float = 600.0) -> None:
    """Runs ``fn(*args)`` (a module-level function) on ranks 0..world-1 of
    one machine, one ``torch.multiprocessing`` process each, with
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set and the group formed at
    ``init_method`` (a ``file://`` path keeps concurrent runs apart).  A
    rank that raises stops the others and raises here; so does the time
    running out.  Gloo rides the loopback interface unless
    ``GLOO_SOCKET_IFNAME`` names another.  Each rank's process imports
    the caller's main module again, so a script that calls this keeps its
    work under ``if __name__ == "__main__"``.  Production runs start their
    ranks with ``torchrun`` instead."""
    import torch.multiprocessing as mp

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.start_processes(
        _rank_main, (fn, world, init_method, backend, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"{fn.__name__} on {world} ranks: over "
                               f"{timeout:.0f} s")

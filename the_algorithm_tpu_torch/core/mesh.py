"""Device-mesh / topology management over ``torch.distributed``.

Counterpart of ``the_algorithm_tpu/core/mesh.py``. The framework runs over
one logical 2-D mesh with axes:

  - ``data``  — data parallelism: batches of requests / training examples
    are sharded here; gradients and metrics sum over it.
  - ``model`` — table/row sharding: embedding tables and the cluster→tweet
    index are row-sharded here; lookups exchange rows by all-to-all over
    this axis.

Where the JAX package runs one program over a ``jax.sharding.Mesh`` of
devices, the port runs one process per device (a rank), each holding its
own blocks: :func:`make_mesh` lays ranks out as JAX lays devices out, rank r
of the mesh's rank list at (r // model, r % model), over a
``torch.distributed.device_mesh.DeviceMesh`` of the same shape. A
:class:`Mesh` answers for its axes the questions a ``shard_map`` body asks
(``lax.axis_size``, ``lax.axis_index``) and runs the collectives a body
calls (``all_gather``, ``psum``, ``all_to_all``).

The process group comes first: ``torch.distributed.init_process_group``
with NCCL on the card (one rank per GPU), gloo on the CPU. ``make_mesh``
builds on the card unless the caller asks for the CPU; with no card it
raises.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
JOINT_AXES = (DATA_AXIS, MODEL_AXIS)  # both, the first major: a rank's place in the whole mesh


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Shape of the logical mesh. ``data * model`` must equal #devices used."""

    data: int = -1  # -1: infer = n_devices // model
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        model = self.model if self.model > 0 else 1
        data = self.data
        if data < 0:
            if n_devices % model != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by model={model}"
                )
            data = n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} != {n_devices} devices"
            )
        return MeshSpec(data=data, model=model)


# the all-gather into one tensor: renamed all_gather_single after torch 2.11
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Mesh:
    """This rank's view of a (data, model) mesh of ranks.

    ``shape[axis]`` is the axis size, :meth:`coord` this rank's index along
    an axis, :meth:`group` the process group of the ranks that share this
    rank's other coordinate. ``device`` is where this rank keeps its blocks.
    """

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        d, m = device_mesh.mesh.shape
        self.shape = {DATA_AXIS: int(d), MODEL_AXIS: int(m)}
        coord = device_mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {device_mesh.mesh.tolist()}")
        self._coord = {DATA_AXIS: coord[0], MODEL_AXIS: coord[1]}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self._coord[axis]

    def position(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes`` taken jointly, the first axis
        major: the block a ``PartitionSpec((axes...))`` gives it."""
        pos = 0
        for axis in axes:
            pos = pos * self.shape[axis] + self.coord(axis)
        return pos

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    # -- collectives over one axis (shard_map's lax.* counterparts) ----------

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """``lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
        ``x`` along ``axis``, concatenated along ``dim`` in coordinate order."""
        n = self.shape[axis]
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather_into(out, x.reshape(-1).contiguous(), group=self.group(axis))
        dim = dim % x.dim()
        out = out.reshape((n,) + tuple(x.shape)).movedim(0, dim)
        return out.reshape(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum(x, axis)``: the sum over ``axis`` (a new tensor)."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group(axis))
        return out

    def pmin(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=self.group(axis))
        return out

    def size(self, axes) -> int:
        """The ranks along ``axes`` (an axis name or a tuple of them) taken jointly."""
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def all_reduce_(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum ``x`` in place over ``axes`` (a name or a tuple), one
        all-reduce an axis longer than 1; an axis of one rank costs nothing."""
        for a in _axes(axes):
            if self.shape[a] > 1:
                dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group(a))
        return x

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a sum over both axes)."""
        self.all_reduce_(torch.zeros(1, device=self.device), JOINT_AXES)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """The mesh's first rank's ``x`` on every rank: zeros elsewhere,
        then a sum over both axes (exact)."""
        out = x.clone() if self.position(JOINT_AXES) == 0 else torch.zeros_like(x)
        return self.all_reduce_(out, JOINT_AXES)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.all_to_all(x, axis, 0, 0)`` of an [E, ...] tensor: block e
        goes to the rank at coordinate e, and block e of the result came
        from it."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axis))
        return out


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# -- collectives under autograd ------------------------------------------------
#
# XLA's partitioner inserts these where a global program meets sharded
# operands; a rank's program states them. Each backward is the transpose of
# its forward over the ranks that share the work: a gather's is a sum of
# the cotangents where the ranks used different rows, and only this rank's
# slice where the work after the gather is the same on every rank.


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.rows = mesh, axes, x.shape[0]
        for a in reversed(axes):  # the minor axis first: blocks land first-axis-major
            x = mesh.all_gather(x, a, dim=0)
        return x

    @staticmethod
    def backward(ctx, dy):
        mesh = ctx.mesh
        d = mesh.all_reduce_(dy.contiguous().clone(), ctx.axes)
        start = mesh.position(ctx.axes) * ctx.rows
        return d[start:start + ctx.rows], None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` along dim 0 over ``axes`` (the first axis major:
    the global batch from its ``PartitionSpec((axes...))`` blocks). Its
    backward sums the cotangent over ``axes`` and keeps this rank's rows: the
    ranks used each other's rows in different work (an in-batch loss's
    negatives). On an axis of one rank it is ``x`` itself."""
    axes = tuple(a for a in _axes(axes) if mesh.shape[a] > 1)
    return _GatherRows.apply(x, mesh, axes) if axes else x


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.cols = mesh, axis, x.shape[-1]
        return mesh.all_gather(x, axis, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        start = ctx.mesh.coord(ctx.axis) * ctx.cols
        return dy[..., start:start + ctx.cols], None, None


def gather_columns(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Every rank's column block of ``x`` along the last dim over ``axis``.
    Its backward keeps this rank's columns of the cotangent, not a sum: the
    work after the gather is the same on every rank of ``axis``."""
    return _GatherColumns.apply(x, mesh, axis) if mesh.shape[axis] > 1 else x


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_reduce_(dy.contiguous().clone(), ctx.axis), None, None


def sum_grad(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """``x`` itself, whose backward sums the cotangent over ``axis``: an
    input the same on every rank of ``axis`` that each rank multiplies by its
    own column block (each rank's cotangent is one block's share)."""
    return _SumGrad.apply(x, mesh, axis) if mesh.shape[axis] > 1 else x


def make_mesh(
    spec: MeshSpec = MeshSpec(),
    ranks: Optional[Sequence[int]] = None,
    *,
    device_type: str = "cuda",
) -> Mesh:
    """Build the (data, model) mesh over the given (default: all) ranks of
    the initialized process group (the JAX package's ``devices``). Every
    rank of the group calls it; a rank outside ``ranks`` gets ValueError.

    ``device_type`` "cuda" (the default) keeps this rank's blocks on its
    current card and raises where there is none; "cpu" is for the tests'
    gloo ranks. The collectives run on the group's backend.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh builds on the GPU by default and none is available: "
                               "pass device_type='cpu'")
        device = torch.device("cuda", torch.cuda.current_device())
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"make_mesh runs on cuda or cpu, not {device_type}")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    spec = spec.resolve(len(ranks))
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(spec.data, spec.model)
    return Mesh(DeviceMesh(device_type, layout, mesh_dim_names=(DATA_AXIS, MODEL_AXIS)), device)


_GLOBAL_MESH: Optional[Mesh] = None


def set_mesh(mesh: Mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh() -> Mesh:
    """Current global mesh; creates an all-data-parallel one on first use."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = make_mesh()
    return _GLOBAL_MESH


@contextmanager
def local_mesh(mesh: Mesh):
    """Temporarily override the global mesh (tests, dry runs)."""
    global _GLOBAL_MESH
    prev = _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    try:
        yield mesh
    finally:
        _GLOBAL_MESH = prev


def host_device_count() -> int:
    """GPUs this host gives its ranks (``jax.local_device_count``)."""
    return torch.cuda.device_count()


# ``force_host_devices`` (XLA's virtual CPU devices for tests) has no
# counterpart: the port's tests spawn one gloo process per rank instead
# (tests/torch_mesh_ranks.py).


def shard_rows(array, mesh: Mesh, axis: int = 0, *, over: Sequence[str] = (MODEL_AXIS,),
               pad: bool = True, what: str = "rows") -> torch.Tensor:
    """This rank's block of a global array (numpy or tensor) split along
    ``axis`` over the mesh ``over`` axes (a ``PartitionSpec`` entry, the
    first axis major), on ``mesh.device``: how a JAX-side global array
    (a table, an index, GFS adjacency, a batch) crosses to the port.

    ``pad``: zero-pad ``axis`` to a multiple of the blocks first (the
    sharded serve's ``_pad_rows``); else a length that does not divide
    raises ValueError.
    """
    t = torch.as_tensor(array)
    n_blocks = 1
    for a in over:
        n_blocks *= mesh.shape[a]
    n = t.shape[axis]
    if n % n_blocks:
        if not pad:
            raise ValueError(f"{what}={n} not divisible by {n_blocks} shards")
        t = pad_rows(t, axis, n_blocks)
    per = t.shape[axis] // n_blocks
    return t.narrow(axis, mesh.position(over) * per, per).contiguous().to(mesh.device)


def pad_rows(t: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """``t`` zero-padded along ``axis`` to a multiple of ``multiple``."""
    pad = (-t.shape[axis]) % multiple
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=axis)

"""Row-sharded embedding tables with collective lookup/update.

Counterpart of ``the_algorithm_tpu/parallel/sharded_table.py``: the
replacement for twml's parameter-server-partitioned embedding variables,
the memcache/Manhattan multiget fan-out
(``SimClustersANNCandidateSource.scala:79``) and GFS's sharded adjacency
lookups.

A table is ``[rows, dim]`` laid out ``P('model', None)``: the rank at model
coordinate m keeps the contiguous block [m·rps, (m+1)·rps) (rps = rows
per shard). Every function here takes and returns this rank's local
tensors as JAX's ``PartitionSpec`` lays them out — an input ``P('model')``
is this rank's block, an input ``P()`` the whole array on every rank — and
is called by every rank of the mesh together.

  - :func:`lookup` — ``table[ids]`` for ids every rank holds: each rank
    gathers the rows it owns and a sum over ``model`` completes them (what
    XLA's partitioner makes of the JAX package's plain gather).
  - :func:`lookup_onehot_psum` — the JAX package's one-hot matmul plus
    psum; here the same masked local gather plus sum, which gives the same
    rows for finite tables (an id no shard owns is a zero row).
  - :func:`multiget_all_to_all` / :func:`lookup_all_to_all` /
    :func:`lookup_collective` — the row-exchange multiget
    (:func:`route_and_gather`): ids go to their owners in one all-to-all,
    each owner gathers its rows through the row-gather kernel, and one
    all-to-all per table brings them back.

Updates go through :func:`scatter_add`: a stable sort plus the D-wide run
collapse (``ops/seg_scan.run_collapse_rows``), so repeated ids sum in a
fixed order with no float atomics.

:func:`lookup` and :func:`lookup_collective` are differentiable in the
table's block, each with the gradient rule of the JAX path it mirrors
(JAX's ``jax.grad`` of the same function on a sharded table gives the same
global gradient):

  - :func:`lookup` reads ``table[ids]`` (a negative id counts from the
    end, then clamped), and its backward drops an id outside the table
    (``gather.grad_ids``), as the transpose of XLA's gather does;
  - :func:`lookup_collective` clips (``route_and_gather``), and a clip's
    gradient follows the clipped row: -1 and -N-1 train row 0, ids past the
    end the last row. An overflowed request trains nothing.

Both backwards end in a stable sort and one ``run_collapse_rows`` into this
rank's [rps, D] block gradient. A table's block is the same on every
'data' rank, and its gradient here is this rank's share: the sum over
'data' is the caller's (``training/trainer.py`` sums each gradient over
the axes that split its batch, in one bucket).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from the_algorithm_tpu_torch.core.mesh import MODEL_AXIS, Mesh, shard_rows
from the_algorithm_tpu_torch.ops.gather import grad_ids, jax_rows, multiget, row_gather
from the_algorithm_tpu_torch.ops.seg_scan import run_collapse_rows


class ShardedTable(NamedTuple):
    """A row-sharded [rows, dim] table: this rank's block and the logical
    (unpadded) row count."""

    local: torch.Tensor  # [rps, dim], rps = ceil(rows / model shards)
    num_rows: int

    @property
    def rows(self) -> int:
        return self.num_rows

    @property
    def dim(self) -> int:
        return self.local.shape[1]


def create(mesh: Mesh, rows: int, dim: int, *, init=None, dtype=torch.float32) -> ShardedTable:
    """A table sharded P('model', None): this rank's block of ``init`` (a
    global [rows, dim] numpy array or tensor), zero-padded to a multiple of
    the model shards, or of zeros."""
    if init is None:
        init = torch.zeros((rows, dim), dtype=dtype)
    local = shard_rows(torch.as_tensor(init).to(dtype), mesh)
    return ShardedTable(local, int(rows))


def _masked_psum(mesh: Mesh, local: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Each rank gathers the requested ``rows`` it owns (zeros elsewhere) in
    one row_gather launch; the sum over 'model' completes them."""
    rps = local.shape[0]
    local_ids = rows.to(torch.int32) - mesh.coord(MODEL_AXIS) * rps
    own = (local_ids >= 0) & (local_ids < rps)
    (got,) = row_gather(torch.where(own, local_ids, 0), local)
    return mesh.psum(torch.where(own[..., None], got, 0), MODEL_AXIS)


def _block_grad(rows: torch.Tensor, dy: torch.Tensor, rps: int) -> torch.Tensor:
    """The [rps, D] sum of ``dy``'s rows by their local row (rows outside
    [0, rps) dropped): a stable sort, then one D-wide run collapse."""
    sorted_rows, perm = torch.sort(rows.reshape(-1).to(torch.int32), stable=True)
    return run_collapse_rows(sorted_rows, perm, dy.reshape(-1, dy.shape[-1]).to(torch.float32).contiguous(), rps)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, ids, mesh, num_rows):
        ctx.save_for_backward(ids)
        ctx.mesh, ctx.num_rows, ctx.rps = mesh, num_rows, local.shape[0]
        return _masked_psum(mesh, local, jax_rows(ids, num_rows))

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        # dy is the same on every 'model' rank (the work after the sum is): no sum back over 'model'
        rows = grad_ids(ids, ctx.num_rows) - ctx.mesh.coord(MODEL_AXIS) * ctx.rps  # PAD_ID stays past the block
        return _block_grad(rows, dy, ctx.rps).to(dy.dtype), None, None, None


def lookup(mesh: Mesh, table: ShardedTable, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows by id, as the JAX package's ``table.array[ids]`` reads
    them (a negative id counts from the end, then clamped): ``ids`` [B] and
    the output [B, dim] are the same on every rank of 'model'. Under
    autograd, ``table.local`` gets this rank's rows of ``jax.grad``'s
    gradient from its batch: an id outside the table trains no row."""
    return _Lookup.apply(table.local, ids, mesh, table.rows)


def lookup_onehot_psum(mesh: Mesh, table: ShardedTable, ids: torch.Tensor) -> torch.Tensor:
    """Explicit-collective lookup: each shard's masked rows summed over
    'model' (the JAX package's one-hot matmul + psum). An id outside
    [0, rows) is a zero row. Requires ``rows % model_shards == 0``; the
    output is float32, as the one-hot product's."""
    n_shards = mesh.shape[MODEL_AXIS]
    if table.rows % n_shards != 0:
        raise ValueError(f"rows={table.rows} not divisible by {n_shards} shards")
    return _masked_psum(mesh, table.local, ids).to(torch.float32)


# -- explicit all-to-all row exchange (the multiget as a collective) ---------


def _flatten(tables) -> Tuple[List[torch.Tensor], Any]:
    """A pytree of tables (a tensor or a :class:`ShardedTable`, a
    tuple/list or a dict of them) → leaves and how to put them back."""
    if isinstance(tables, (torch.Tensor, ShardedTable)):
        return [tables], None
    if isinstance(tables, dict):
        return list(tables.values()), list(tables)
    return list(tables), type(tables)


def _unflatten(leaves: List[torch.Tensor], how):
    if how is None:
        return leaves[0]
    if isinstance(how, list):
        return dict(zip(how, leaves))
    return how(leaves)


def _gather_local(idx: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """``leaf[idx]`` for every leaf through ``gather.multiget``: row_gather
    launches of up to ``MAX_TABLES`` tables, 16-byte rows (the TMA ring)
    apart from the rest."""
    got = multiget(dict(enumerate(leaves)), idx)
    return [got[i] for i in range(len(leaves))]


class _Routes(NamedTuple):
    """Where :func:`route_and_gather` put each request: ``slot`` [B] (its
    place in the [E, cap] send buffer, or E·cap when it overflowed),
    ``valid`` [B], and ``local_idx`` [E, cap], the rows of this rank's
    block that its peers asked for (clipped)."""

    slot: torch.Tensor
    valid: torch.Tensor
    local_idx: torch.Tensor


def _routes(ids: torch.Tensor, rps: int, mesh: Mesh, cap: int, axis: str = MODEL_AXIS) -> _Routes:
    """Bucket ``ids`` by owner and send them there (the multiget's
    collective 1); at E == 1 the local rows ``clip(ids, 0, rps-1)``."""
    E = mesh.shape[axis]
    B = ids.shape[0]
    ids = ids.to(torch.int32)
    if E == 1:
        slot = torch.arange(B, device=ids.device)
        return _Routes(slot, torch.ones(B, dtype=torch.bool, device=ids.device), ids.clamp(0, rps - 1).reshape(1, B))
    owner = torch.div(ids, rps, rounding_mode="floor").clamp_(0, E - 1)
    onehot = owner[:, None] == torch.arange(E, dtype=torch.int32, device=ids.device)
    running = torch.cumsum(onehot.to(torch.int32), dim=0, dtype=torch.int32)
    pos = torch.where(onehot, running, 0).sum(dim=1, dtype=torch.int32) - 1  # [B]
    valid = pos < cap
    slot = torch.where(valid, owner * cap + pos, E * cap).long()
    send = torch.zeros(E * cap + 1, dtype=torch.int32, device=ids.device)
    send[slot] = ids  # the dropped slot E·cap is cut off below
    # collective 1: ids → owners. recv[e] = ids rank e requests from us.
    recv = mesh.all_to_all(send[:E * cap].reshape(E, cap), axis)
    return _Routes(slot, valid, (recv - mesh.coord(axis) * rps).clamp_(0, rps - 1))


def route_and_gather(local_tables, ids: torch.Tensor, *, rows_per_shard: int, mesh: Mesh,
                     capacity: Optional[int] = None, axis: str = MODEL_AXIS):
    """This rank's multiget over ``axis`` (the JAX package's shard_map body).

    ``local_tables``: pytree of ``[rows_per_shard, ...]`` tensors, this
    shard's contiguous row block (shard s owns rows [s·rps, (s+1)·rps)).
    ``ids``: [B] ids requested by *this* rank; every rank of the axis
    passes the same B.

    Protocol (two collectives, both over ``axis``):
      1. bucket ids by owner ``clip(id // rps, 0, E-1)``, each id's place in
         its bucket a running count (request order kept within a bucket),
         into an [E, cap] send buffer; ``all_to_all`` the ids — each owner
         receives the ids every peer wants from it (``_routes``);
      2. owners gather their rows (``gather.multiget``: a row_gather
         launch for up to three tables) at ``clip(id - offset, 0, rps-1)``, ``all_to_all`` each
         leaf back, and each requester unpermutes by a gather.

    ``capacity`` bounds the per-(requester→owner) slot count. Default B —
    always exact. An id past the capacity gets the dropped slot E·cap,
    comes back as a zero row, and is counted in the returned ``overflow``.
    At E == 1 the multiget is the local gather of ``clip(ids, 0, rps-1)``.
    So -1 reads row 0 and PAD_ID the last row, as in JAX (not
    ``gather.jax_rows``' wrap).

    Returns ``(rows_pytree, overflow)``: each rows leaf [B, ...], overflow a
    0-d int32 tensor (this rank's dropped requests).
    """
    leaves, how = _flatten(local_tables)
    cap = int(capacity) if capacity else ids.shape[0]
    r = _routes(ids, rows_per_shard, mesh, cap, axis)
    out = [_exchange_back(got, r, mesh, axis) for got in _gather_local(r.local_idx, leaves)]
    overflow = (ids.shape[0] - r.valid.sum()).to(torch.int32)
    return _unflatten(out, how), overflow


def _exchange_back(got: torch.Tensor, r: _Routes, mesh: Mesh, axis: str) -> torch.Tensor:
    """The owners' gathered [E, cap, ...] rows back to their requesters
    (collective 2), unpermuted into request order; overflowed requests 0."""
    if mesh.shape[axis] == 1:
        return got[0]
    E, cap = got.shape[:2]
    back = mesh.all_to_all(got, axis).reshape((E * cap,) + got.shape[2:])  # back[o] = rows owner o sent us
    # unpermute as a GATHER: request i's row sits at its own slot
    row = back.index_select(0, torch.where(r.valid, r.slot, 0))
    return torch.where(r.valid.reshape((-1,) + (1,) * (row.dim() - 1)), row, 0)


def _rows_and_locals(tables) -> Tuple[Any, int]:
    """The pytree of local blocks and the logical row count of its first
    leaf (a :class:`ShardedTable`'s ``rows``, else its block × shards)."""
    leaves, how = _flatten(tables)
    first = leaves[0]
    locals_ = [t.local if isinstance(t, ShardedTable) else t for t in leaves]
    return _unflatten(locals_, how), (first.rows if isinstance(first, ShardedTable) else None)


def multiget_all_to_all(mesh: Mesh, tables, ids: torch.Tensor, *, capacity: Optional[int] = None,
                        return_overflow: bool = False):
    """Row-exchange multiget over a pytree of same-rows tables.

    ``tables``: :class:`ShardedTable` leaves or local blocks, all
    P('model', …). ``ids``: this rank's [B/E] block of the request batch
    (P('model'); ``shard_rows(ids, mesh, pad=False, what="batch")`` takes
    it and raises when B % E != 0). Outputs: this rank's [B/E, ...] rows.
    Routing happens once; every leaf rides the second exchange. With
    ``return_overflow`` also the dropped requests summed over the shards.
    """
    locals_, rows = _rows_and_locals(tables)
    n_shards = mesh.shape[MODEL_AXIS]
    rps = _flatten(locals_)[0][0].shape[0]
    if rows is not None and rows % n_shards != 0:
        raise ValueError(f"rows={rows} not divisible by {n_shards} shards")
    out, overflow = route_and_gather(locals_, ids, rows_per_shard=rps, mesh=mesh, capacity=capacity)
    if return_overflow:
        return out, mesh.psum(overflow, MODEL_AXIS)
    return out


def lookup_all_to_all(mesh: Mesh, table: ShardedTable, ids: torch.Tensor, *, capacity: Optional[int] = None,
                      return_overflow: bool = False):
    """Sharded-table lookup via the all-to-all row exchange."""
    return multiget_all_to_all(mesh, table, ids, capacity=capacity, return_overflow=return_overflow)


class _LookupCollective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, ids, mesh, cap):
        r = _routes(ids, local.shape[0], mesh, cap)
        ctx.save_for_backward(r.slot, r.valid, r.local_idx)
        ctx.mesh, ctx.rps = mesh, local.shape[0]
        (got,) = _gather_local(r.local_idx, [local])
        return _exchange_back(got, r, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, dy):
        slot, valid, local_idx = ctx.saved_tensors
        mesh = ctx.mesh
        E, cap = local_idx.shape
        dy = dy.reshape(-1, dy.shape[-1])
        if E > 1:  # collective 2 reversed: each request's cotangent to its slot, then to its owner
            d = dy.new_zeros((E * cap, dy.shape[1]))
            d[slot[valid]] = dy[valid]  # overflowed requests train nothing
            dy = mesh.all_to_all(d.reshape(E, cap, -1), MODEL_AXIS)
        # a slot no request filled reads a clipped row and carries a zero cotangent
        return _block_grad(local_idx, dy, ctx.rps).to(dy.dtype), None, None, None


def lookup_collective(table: ShardedTable, ids: torch.Tensor, mesh: Mesh, *,
                      capacity: Optional[int] = None) -> torch.Tensor:
    """Training-path lookup: the batch sharded over ('data', 'model')
    jointly. ``ids`` is this rank's block of it (the rank at (d, m) holds
    block d·E + m: ``shard_rows(ids, mesh, over=(DATA_AXIS, MODEL_AXIS),
    pad=False, what="batch")``); rows are exchanged only within this
    rank's 'model' group, and the output keeps the joint batch block.

    Differentiable in ``table.local`` (the JAX shard_map's transpose): each
    row's cotangent goes back through the same routing reversed (one
    all-to-all over 'model'), and the owner sums what it receives by local
    row, a stable sort and one ``run_collapse_rows``. The result is this
    rank's share of the block's gradient, from its 'model' group's batch."""
    n_shards = mesh.shape[MODEL_AXIS]
    if table.rows % n_shards != 0:
        raise ValueError(f"rows={table.rows} not divisible by {n_shards} shards")
    return _LookupCollective.apply(table.local, ids, mesh, int(capacity) if capacity else ids.shape[0])


def scatter_add(mesh: Mesh, table: ShardedTable, ids: torch.Tensor, updates: torch.Tensor) -> ShardedTable:
    """table[ids] += updates with ids and updates the same on every rank
    (duplicate ids accumulate; an id the JAX package's scatter drops — past
    either end after a negative id counts from the end — is dropped). Each
    rank adds the updates of the rows it owns: a stable sort of their ids,
    then one D-wide run collapse (``run_collapse_rows``) into a [rps, D]
    sum, each row written once, in slot order."""
    rps = table.local.shape[0]
    flat_ids = grad_ids(ids.reshape(-1), table.rows) - mesh.coord(MODEL_AXIS) * rps
    flat_updates = updates.reshape(-1, updates.shape[-1]).to(torch.float32).contiguous()
    sorted_ids, perm = torch.sort(flat_ids.to(torch.int32), stable=True)  # ids outside [0, rps) are dropped
    delta = run_collapse_rows(sorted_ids, perm, flat_updates, rps)
    return ShardedTable(table.local + delta.to(table.local.dtype), table.rows)


def row_decay(table: ShardedTable, factor: float) -> ShardedTable:
    """Uniform exponential decay of all rows (half-life maintenance)."""
    return ShardedTable(table.local * torch.tensor(factor, dtype=table.local.dtype), table.rows)

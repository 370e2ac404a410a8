"""Model-axis-sharded serve path: the hydration store as a device fleet.

Counterpart of ``the_algorithm_tpu/mixers/sharded_serve.py`` (the
reference's sharded hydration tier: feature hydrators batching RPCs to
*partitioned* Manhattan/memcache/GFS backends). Every
:class:`~the_algorithm_tpu_torch.mixers.device_hydration.DeviceWideTables`
leaf is row-sharded ``P('model', …)`` over the mesh, so the serve path's
table capacity grows with the device count, and each rank runs the same
hydrate+score pass over its part of the batch.

Layout (mesh axes ``(data, model)``), on every rank of the mesh:

  - requests shard over ``data`` — R/dd rows per data slice;
  - candidate slots AND table rows shard over ``model`` — each rank
    hydrates and scores its own PB/E candidate columns, resolving table
    rows it does not own with the row-exchange multiget
    (:func:`~the_algorithm_tpu_torch.parallel.sharded_table.route_and_gather`,
    each owner's gather one row_gather launch);
  - per-request scores are gathered over ``model`` (probs ‖ combined, one
    collective) for the replicated diversity top-K, and a final gather over
    ``data`` hands every rank the whole batch's result.

The keyed tables are packed once: per route of
:func:`~the_algorithm_tpu_torch.mixers.device_hydration.keyed_table_plan`,
float leaves as f32 and int leaves as int32 concatenated by column, so a
route pays one id exchange, at most two row exchanges and one row_gather
launch of two tables on the owner. The packed leaves replace the tables:
the engine keeps only placeholders of them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_rows
from the_algorithm_tpu_torch.mixers import device_hydration as dh
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.parallel.sharded_table import route_and_gather

# shard axis per DeviceWideTables field; None = replicated
_SHARD_AXIS: Dict[str, Optional[int]] = {
    "doc_table": 0,
    "rg_nbr_ids": 0, "rg_counts": 0, "rg_last_ts": 0,
    "rg_w": None, "rg_b": None,
    "twhin_user": 0, "twhin_author": 0, "twhin_tweet": 0,
    "twhin_user_negative": 0, "twhin_author_follow": 0,
    "eng_ids": 0, "eng_type": 0, "eng_ts": 0, "eng_valid": 0,
    "user_interests": 0, "author_agg_emb": 0, "media_clip": 0, "text_emb": 0,
    "agg_values": 0, "agg_last_ts": 0,  # per tuple element
    "uss_ids": 0, "uss_ts": 0,
    "gfs_neighbors": 1,  # [E_ent, U, D] — the U axis is the keyed one
    "tweepcred": 0, "author_meta": 0,
}

# caps-dict name per gather_rows key → DeviceWideTables field
_CAP_FIELDS = {
    "doc": "doc_table",
    "tw_tweet": "twhin_tweet", "media_clip": "media_clip",
    "text_emb": "text_emb",
    "tw_author": "twhin_author", "tw_author_follow": "twhin_author_follow",
    "author_agg_emb": "author_agg_emb",
    "tweepcred": "tweepcred", "author_meta": "author_meta",
    "rg_nbrs": "rg_nbr_ids", "rg_counts": "rg_counts", "rg_last": "rg_last_ts",
    "tw_user": "twhin_user", "tw_user_neg": "twhin_user_negative",
    "eng_ids": "eng_ids", "eng_type": "eng_type", "eng_ts": "eng_ts",
    "eng_valid": "eng_valid",
    "user_interests": "user_interests",
    "uss_ids": "uss_ids", "uss_ts": "uss_ts",
}


def table_capacities(tables: dh.DeviceWideTables) -> Dict[str, int]:
    """Logical (unpadded) row counts, keyed by gather_rows cap names."""
    caps = {name: int(getattr(tables, field).shape[0]) for name, field in _CAP_FIELDS.items()}
    caps["gfs_neighbors"] = int(tables.gfs_neighbors.shape[1])
    return caps


def place_tables(tables: dh.DeviceWideTables, mesh: Mesh) -> Tuple[dh.DeviceWideTables, Dict[str, object]]:
    """This rank's blocks of every table: shard axes zero-padded to the
    model-group size (``core.mesh.pad_rows``, the JAX module's
    ``_pad_rows``) and split ``P('model', …)``, replicated leaves whole,
    all on the mesh's device. Returns (placed tables, the shard axis of
    each field, None where replicated). Each rank holds rows/E of each
    sharded leaf. The aggregate pack (``agg_packed``) is not placed."""
    placed, axes = {}, {}
    for name in _SHARD_AXIS:
        axis = _SHARD_AXIS[name]
        val = getattr(tables, name)

        def leaf(t):
            return t.to(mesh.device) if axis is None else shard_rows(t, mesh, axis)

        placed[name] = tuple(leaf(v) for v in val) if isinstance(val, tuple) else leaf(val)
        axes[name] = axis
    return dh.DeviceWideTables(**placed), axes


def _sharded_gather(mesh: Mesh, group: Dict[str, torch.Tensor], key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """gather_rows hook for a group that rides no packed route: the
    all-to-all multiget over the ``model`` axis. ``group`` leaves are this
    rank's row shards; ``key`` this rank's own requests. One routing serves
    every leaf. (The JAX package sends bool leaves as uint8; the port's
    tables hold no bool leaf: ``eng_valid`` is int32 0/1, as ``row_gather``
    copies 4-byte words.)"""
    rps = next(iter(group.values())).shape[0]
    rows, _ = route_and_gather(group, key.reshape(-1), rows_per_shard=rps, mesh=mesh)
    return {n: r.reshape(key.shape + r.shape[1:]) for n, r in rows.items()}


class ShardedServeEngine:
    """The batched hydrate+score engine over a ``(data, model)`` mesh.

    Drop-in for :class:`~the_algorithm_tpu_torch.mixers.device_hydration.
    DeviceHydrationScorer` (same ``score_requests`` / ``score_columnar`` /
    ``select_columnar`` contract) with the tables partitioned across the
    mesh. Every rank of the mesh builds it from the same global tables and
    calls it with the same batch, as the JAX package's one program takes
    one host batch; every rank gets the whole result. ``model`` is a
    :class:`~the_algorithm_tpu_torch.models.masknet.MaskNet` on the mesh's
    device holding the (replicated) weights.
    """

    def __init__(
        self,
        tables: dh.DeviceWideTables,
        fns: dh.DeviceFns,
        resolvers,
        model: torch.nn.Module,
        head_weights,
        mesh: Mesh,
        *,
        pad_b: int = 512,
        source_names: Optional[Sequence[str]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        select_top_k: Optional[int] = None,
        diversity_decay: float = 0.5,
        diversity_floor: float = 0.25,
    ):
        self.mesh = mesh
        E = mesh.shape[MODEL_AXIS]
        if pad_b % E != 0:
            raise ValueError(f"pad_b={pad_b} not divisible by model={E}")
        self.builder = dh.HostRequestBuilder(resolvers, source_names=source_names, pad_b=pad_b)
        self.fns = fns
        self.model = model
        self.head_weights = torch.as_tensor(head_weights, dtype=torch.float32).to(mesh.device)
        self.compute_dtype = compute_dtype
        self.select_top_k = select_top_k
        self.diversity_decay = diversity_decay
        self.diversity_floor = diversity_floor
        self.caps = caps = table_capacities(tables)

        # the 18 aggregate stores as ONE row-concatenated table: all store
        # rows resolve in one routed gather instead of 18
        store_caps = [int(v.shape[0]) for v in tables.agg_values]
        offsets = np.zeros(len(store_caps), np.int32)
        offsets[1:] = np.cumsum(store_caps)[:-1]
        self._agg = dh.AggPacked(shard_rows(torch.cat(tables.agg_values), mesh),
                                 shard_rows(torch.cat(tables.agg_last_ts), mesh),
                                 torch.from_numpy(offsets).to(mesh.device))
        self._compact_rows = all(c < 32768 for c in store_caps)

        # every keyed-table route packed into ONE exchange buffer per dtype
        # class: a route pays one id exchange and at most two row exchanges
        # however many tables ride it
        plan = dh.keyed_table_plan(tables, caps)
        if caps["author_meta"] != caps["tweepcred"]:
            # the double-modulo author_meta route lives outside the plan
            plan[("author_meta_dm", caps["author_meta"])] = {"author_meta": tables.author_meta}
        self._route_of: Dict[frozenset, str] = {}
        self._route_meta: Dict[str, list] = {}
        self._packs: Dict[str, Dict[str, torch.Tensor]] = {}
        for (flavor, cap), group in plan.items():
            route = f"{flavor}::{cap}"
            self._route_of[frozenset(group)] = route
            meta, bufs, offs = [], {"f": [], "i": []}, {"f": 0, "i": 0}
            for name in sorted(group):
                leaf = group[name]
                tail = tuple(leaf.shape[1:])
                w = int(np.prod(tail)) if tail else 1
                cls = "f" if leaf.is_floating_point() else "i"
                bufs[cls].append(leaf.reshape(cap, w).to(torch.float32 if cls == "f" else torch.int32))
                meta.append((name, cls, offs[cls], w, tail, leaf.dtype))
                offs[cls] += w
            self._route_meta[route] = meta
            self._packs[route] = {cls: shard_rows(torch.cat(parts, dim=1), mesh) for cls, parts in bufs.items()
                                  if parts}

        # the real leaves are superseded by the packed routes: each keyed
        # table becomes a placeholder (gather_rows reads group NAMES only;
        # capacities come from ``caps``) — the shard axis E rows, so each
        # rank holds one; leading dims stay (the GFS entity axis is indexed
        # statically), trailing dims shrink to 1
        def placeholder(name, arr):
            shape = list(arr.shape)
            axis = _SHARD_AXIS[name]
            shape[axis] = E
            for d in range(axis + 1, arr.dim()):
                shape[d] = 1
            return torch.zeros(shape, dtype=arr.dtype)

        tables = tables._replace(
            agg_values=tuple(torch.zeros((E, 1)) for _ in store_caps),
            agg_last_ts=tuple(torch.zeros((E,), dtype=torch.int32) for _ in store_caps),
            agg_packed=None,
            **{f: placeholder(f, getattr(tables, f)) for f in _SHARD_AXIS
               if f not in ("agg_values", "agg_last_ts") and _SHARD_AXIS[f] is not None},
        )
        self.tables, _ = place_tables(tables, mesh)

    def _gather(self, group: Dict[str, torch.Tensor], key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """gather_rows hook: a packed route's multiget, unpacked by name."""
        route = self._route_of.get(frozenset(group))
        if route is None:  # the packed aggregate stores ride their own route
            return _sharded_gather(self.mesh, group, key)
        packs = self._packs[route]
        rps = next(iter(packs.values())).shape[0]
        got, _ = route_and_gather(packs, key.reshape(-1), rows_per_shard=rps, mesh=self.mesh)
        out = {}
        for name, cls, off, w, tail, dt in self._route_meta[route]:
            r = got[cls][:, off:off + w].reshape(key.shape + tail)
            out[name] = r if r.dtype == dt else r.to(dt)
        return out

    def _run(self, packed: torch.Tensor) -> torch.Tensor:
        """This rank's pass over its data block of the packed batch: [Rl, PB,
        H+1] (probs ‖ combined), or with ``select_top_k`` [Rl, K, H+2]
        (probs ‖ score ‖ bitcast id)."""
        mesh = self.mesh
        PBe = self.builder.pad_b // mesh.shape[MODEL_AXIS]
        with torch.inference_mode():
            req = dh.unpack_requests(packed, self.builder.follow_width, compact_rows=self._compact_rows)
            cols = slice(mesh.coord(MODEL_AXIS) * PBe, (mesh.coord(MODEL_AXIS) + 1) * PBe)
            loc = req._replace(cand_ids=req.cand_ids[:, cols], author_ids=req.author_ids[:, cols],
                               agg_rows=req.agg_rows[:, cols], lift=req.lift[:, cols],
                               source_idx=req.source_idx[:, cols])
            rows = dh.gather_rows(self.tables, loc, gather=self._gather, caps=self.caps, agg_packed=self._agg)
            x = dh.assemble_from_rows(rows, self.fns, loc, n_sources=self.builder.n_sources,
                                      eng_rows=self.caps["eng_ids"])
            Rl, _, F = x.shape
            probs = torch.sigmoid(self.model(x.reshape(Rl * PBe, F).to(self.compute_dtype)))
            probs = probs.reshape(Rl, PBe, -1).float()
            combined = masknet.weighted_model_score(probs, self.head_weights)
            # the full candidate axis for the replicated top-K: ONE collective
            both = mesh.all_gather(torch.cat([probs, combined[..., None]], dim=-1), MODEL_AXIS, dim=1)
            if self.select_top_k is None:
                return both
            probs_full = both[..., :-1]
            sel_idx, sel_ids, sel_scores = dh.diversity_select(
                both[..., -1], req.author_ids, req.cand_ids, self.select_top_k,
                decay=self.diversity_decay, floor=self.diversity_floor)
            sel_probs = torch.gather(probs_full, 1, sel_idx[..., None].expand(-1, -1, probs_full.shape[-1]))
            return torch.cat([sel_probs, sel_scores[..., None], sel_ids.view(torch.float32)[..., None]], dim=-1)

    def _dispatch_packed(self, reqs) -> np.ndarray:
        stacked = dh.batch_requests(reqs)
        R = stacked.cand_ids.shape[0]
        dd = self.mesh.shape[DATA_AXIS]
        pad = (-R) % dd
        if pad:  # data-axis divisibility: repeat the first request row
            stacked = dh.DeviceRequests(*(np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)
                                          for x in stacked))
        packed = dh.pack_requests(stacked, compact_rows=self._compact_rows)
        out = self._run(shard_rows(packed, self.mesh, over=(DATA_AXIS,), pad=False, what="requests"))
        return self.mesh.all_gather(out, DATA_AXIS, dim=0).cpu().numpy()[:R]  # one fetch

    def score_requests(self, batch):
        """batch: [(query, candidates), ...] → [(probs, combined), ...]."""
        out = self._dispatch_packed([self.builder.build(q, c) for q, c in batch])
        return [(out[i, :min(len(c), out.shape[1]), :-1], out[i, :min(len(c), out.shape[1]), -1])
                for i, (_, c) in enumerate(batch)]

    def score_columnar(self, batch):
        """batch: [(query, cols, n), ...] → [(probs [n, H], combined [n])]."""
        if self.select_top_k is not None:
            raise RuntimeError("engine built with select_top_k: use select_columnar")
        out = self._dispatch_packed([self.builder.build_columnar(q, cols, n) for q, cols, n in batch])
        return [(out[i, :min(n, out.shape[1]), :-1], out[i, :min(n, out.shape[1]), -1])
                for i, (_, _, n) in enumerate(batch)]

    def select_columnar(self, batch):
        """Device-selected path → [(sel_ids [K], sel_scores [K],
        sel_probs [K, H]), ...]."""
        out = self._dispatch_packed([self.builder.build_columnar(q, cols, n) for q, cols, n in batch])
        probs, scores = out[..., :-2], out[..., -2]
        ids = np.ascontiguousarray(out[..., -1]).view(np.int32)
        res = []
        for i in range(len(batch)):
            ok = np.isfinite(scores[i])
            res.append((ids[i][ok], scores[i][ok], probs[i][ok]))
        return res

"""Device-side wide hydration: the serve-path feature store on the card.

Counterpart of ``the_algorithm_tpu/mixers/device_hydration.py`` (the
reference's hydration tier: feature hydrators batching RPCs to the stores,
then ``navi/dr_transform`` densifying the result for the model). Every
feature table lives on the device; the host only resolves ids → rows (the
memcache-key layer) and uploads one packed int32 buffer per request batch.

Where the JAX package reads each keyed table with plain indexing, the port
reads them through the multiget kernel: :func:`multiget` puts each
(key flavor, capacity) group of :func:`keyed_table_plan` through
:func:`~the_algorithm_tpu_torch.ops.gather.row_gather` in launches of up to
three tables, 16-byte rows together (the TMA ring takes them) and the rest
together (one 4-byte row sends a launch to the word kernel). The aggregate
stores are read packed (:func:`pack_agg_stores`, once per set of
tables): the 18 stores concatenated row-wise, all their rows in two
launches. Tables with 1-D or
3-D rows are viewed as [rows, width].

:func:`assemble` emits columns in exactly
:data:`feature_schema.WIDE_SCHEMA` order; ``tests/test_torch_hydration.py``
holds it to the JAX package's per schema family.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.features import aggregation, graph_features
from the_algorithm_tpu_torch.features import representation_scorer as rsx
from the_algorithm_tpu_torch.graph import realgraph
from the_algorithm_tpu_torch.mixers import feature_schema as fs
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.ops import gather as gather_ops
from the_algorithm_tpu_torch.ops import retrieval, sparse
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

# aggregate-store catalog order == schema prefix order (feature_schema.py):
# first the candidate-keyed stores (a [B] row vector each), then the
# viewer-keyed stores (one row broadcast over the batch)
CAND_KEYED_AGG = (
    "tweet_agg", "author_agg", "user_author_agg", "user_author_oon_agg",
    "user_engager_agg", "user_mention_agg", "user_original_author_agg",
    "user_topic_agg", "author_topic_agg", "user_source_agg",
    "user_language_agg", "user_media_agg", "user_conversation_agg",
    "topic_agg",
)
VIEWER_KEYED_AGG = ("user_agg", "user_list_agg", "user_dow_agg", "user_hour_agg")
# schema emission order of all agg prefixes (feature_schema.build_wide_schema)
AGG_SCHEMA_ORDER = (
    "tweet_agg", "author_agg", "user_agg", "user_author_agg",
    *fs.PAIR_AGG_PREFIXES, *fs.EXTRA_AGG_PREFIXES,
)

_L = len(fs.ENGAGEMENT_LABELS)
_H = len(fs.AGG_HALFLIVES_S)
_M_STORED = 4  # count, sum, sumsq, max
USS_WINDOWS_S = (90 * 86400, 30 * 86400, 7 * 86400)  # fs.USS_WINDOW_NAMES order


class AggPacked(NamedTuple):
    """The aggregate stores concatenated row-wise (CAND_KEYED_AGG then
    VIEWER_KEYED_AGG): one table for the multiget."""

    values: torch.Tensor  # [Σ cap_i, L*4*H]
    last_ts: torch.Tensor  # [Σ cap_i]
    offsets: torch.Tensor  # [S+V] int32: each store's first row


class DeviceWideTables(NamedTuple):
    """Every serve-path feature table, on one device."""

    # earlybird in-index doc features [Td, n_doc] (ids gather mod Td)
    doc_table: torch.Tensor
    # realgraph viewer rows
    rg_nbr_ids: torch.Tensor  # [U, D] int32
    rg_counts: torch.Tensor  # [U, D, Fr] f32
    rg_last_ts: torch.Tensor  # [U] int32
    rg_w: torch.Tensor  # [Fr] edge-model weights
    rg_b: torch.Tensor  # [] bias
    # twhin embedding tables
    twhin_user: torch.Tensor  # [U, 64]
    twhin_author: torch.Tensor  # [A, 64]
    twhin_tweet: torch.Tensor  # [Tw, 64]
    twhin_user_negative: torch.Tensor  # [U, 64]
    twhin_author_follow: torch.Tensor  # [A, 64]
    # rsx engagement history (per viewer)
    eng_ids: torch.Tensor  # [U, E] int32 engaged-tweet ids
    eng_type: torch.Tensor  # [U, E] int32
    eng_ts: torch.Tensor  # [U, E] int32
    eng_valid: torch.Tensor  # [U, E] int32 0/1 (JAX: bool; the multiget copies 4-byte words)
    # large embeddings
    user_interests: torch.Tensor  # [U, 128]
    author_agg_emb: torch.Tensor  # [A, 128]
    media_clip: torch.Tensor  # [Tw, 64]
    text_emb: torch.Tensor  # [Tw, 128]
    # aggregate stores, order = CAND_KEYED_AGG + VIEWER_KEYED_AGG
    agg_values: Tuple[torch.Tensor, ...]  # each [cap_i, L*4*H]
    agg_last_ts: Tuple[torch.Tensor, ...]  # each [cap_i]
    # USS ring buffers
    uss_ids: torch.Tensor  # [U, S, W] int32
    uss_ts: torch.Tensor  # [U, S, W] int32
    # GFS adjacency
    gfs_neighbors: torch.Tensor  # [E, U, D] int32
    # author meta
    tweepcred: torch.Tensor  # [A]
    author_meta: torch.Tensor  # [A, 4]
    # the aggregate stores packed row-wise (pack_agg_stores; agg_values and
    # agg_last_ts are then views into it), or None: read store by store
    agg_packed: Optional[AggPacked] = None

    def to(self, device) -> "DeviceWideTables":
        """The same tables on ``device`` (the aggregate stores packed)."""
        return pack_agg_stores(DeviceWideTables(*(
            tuple(t.to(device) for t in f) if isinstance(f, tuple) else f.to(device)
            for f in self[:-1])))


@dataclasses.dataclass(frozen=True)
class DeviceFns:
    """Feature formulas over tensors (production backs these with table
    gathers; the synthetic world supplies closed-form ones)."""

    # ids [...] -> (cluster_ids [..., K] int32, scores [..., K] f32)
    tweet_emb: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
    # (uid [..], authors [...]) -> bool [...]: does author follow viewer
    author_follows_viewer: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class DeviceRequests(NamedTuple):
    """One batch of R requests, PB candidate slots each: numpy arrays as the
    host builds them, tensors once unpacked on the device."""

    cand_ids: Any  # [R, PB] int32 (PAD_ID for empty slots)
    author_ids: Any  # [R, PB] int32 (-1 for empty)
    agg_rows: Any  # [R, PB, len(CAND_KEYED_AGG)] int32 (-1 = miss)
    viewer_agg_rows: Any  # [R, len(VIEWER_KEYED_AGG)] int32
    uid: Any  # [R] int32
    now: Any  # [R] int32
    follows: Any  # [R, FW] int32 (PAD_ID padded)
    lift: Any  # [R, PB, 6] f32 — CONTEXT_FEATURES order
    ctx_hour: Any  # [R] int32
    ctx_dow: Any  # [R] int32
    ctx_client: Any  # [R] int32
    ctx_scalars: Any  # [R, 4] f32
    source_idx: Any  # [R, PB] int32 (-1 = unknown source)


def pack_agg_stores(tables: DeviceWideTables) -> DeviceWideTables:
    """``tables`` with its aggregate stores packed once for
    :func:`gather_rows` (``agg_packed``), every store a view into the pack."""
    caps = [v.shape[0] for v in tables.agg_values]
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    packed = AggPacked(torch.cat(tables.agg_values), torch.cat(tables.agg_last_ts),
                       torch.from_numpy(offsets).to(tables.doc_table.device))
    return tables._replace(agg_values=torch.split(packed.values, caps), agg_last_ts=torch.split(packed.last_ts, caps),
                           agg_packed=packed)


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot with ``jax.nn.one_hot``'s rule: an index outside
    [0, n) (the -1 of an unknown source) gives a row of zeros."""
    return (x[..., None] == torch.arange(n, device=x.device)).float()


def _bucket_proj(cl: torch.Tensor, sc: torch.Tensor, buckets: int) -> torch.Tensor:
    """[..., K] sparse pairs → [..., buckets] hash-bucketed dense sum
    (the SparseProjectionColumnarHydrator math). A one-hot sum over K, as in
    JAX, not a scatter-add: atomics would sum a bucket's entries in another
    order on each run, and two runs of a batch must score alike."""
    valid = cl != PAD_ID
    b = torch.where(valid, torch.remainder(cl, buckets), 0)
    return (_one_hot(b, buckets) * torch.where(valid, sc, 0.0)[..., None]).sum(dim=-2)


def _agg_expose_rows(block: torch.Tensor, last: torch.Tensor, rows: torch.Tensor, now) -> torch.Tensor:
    """Decay-to-now + expose pre-gathered store rows → [..., L*H*5].

    ``block`` [..., L*4*H] and ``last`` [...] were gathered at max(rows, 0);
    ``rows`` (-1 = missing) only masks. Stored layout col=((l*4 + m)*H + h);
    exposed order (label, half-life, count/sum/mean/sumsq/max).
    """
    dt = (now - last).float()[..., None]
    hl_cols = torch.tensor(fs.AGG_HALFLIVES_S, dtype=torch.float32, device=block.device).repeat(_L * _M_STORED)
    block = block * torch.exp2(-dt / hl_cols)
    block = torch.where((rows >= 0)[..., None], block, 0.0)
    shape = block.shape[:-1]
    cube = block.reshape(*shape, _L, _M_STORED, _H).transpose(-1, -2)  # [..., L, H, M_STORED]
    count, ssum = cube[..., 0], cube[..., 1]
    out = torch.stack([count, ssum, ssum / torch.clamp(count, min=1.0), cube[..., 2], cube[..., 3]], dim=-1)
    return out.reshape(*shape, _L * _H * 5)


def _cap_of(caps: Optional[Dict[str, int]], name: str, arr, axis: int = 0) -> int:
    """True (unpadded) row count of a keyed table.

    Inside the sharded engine (``mixers/sharded_serve.py``) a leaf holds
    only its local shard, zero-padded to a shard multiple, or a placeholder,
    so modulo keys come from the recorded logical capacities, never from
    ``shape[0]``.
    """
    if caps is not None and name in caps:
        return caps[name]
    return arr.shape[axis]


def keyed_table_plan(tables: DeviceWideTables, caps: Optional[Dict[str, int]] = None
                     ) -> Dict[Tuple[str, int], Dict[str, torch.Tensor]]:
    """The gather route plan: (key flavor, capacity) → named table group.
    Tables sharing a key flavor AND row count read with one key array. Used
    by :func:`gather_rows` (which computes each route's key) and by the
    sharded engine's packer (which concatenates each group into one
    exchange buffer), so the two never disagree on what rides which route.
    ``caps``: the logical row counts (``sharded_serve.table_capacities``)."""
    A_m = _cap_of(caps, "tweepcred", tables.tweepcred)
    A_m2 = _cap_of(caps, "author_meta", tables.author_meta)
    U_g = _cap_of(caps, "gfs_neighbors", tables.gfs_neighbors, axis=1)
    plan: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}

    def add(flavor, name, tab, cap=None):
        plan.setdefault((flavor, int(_cap_of(caps, name, tab) if cap is None else cap)), {})[name] = tab

    add("ids", "doc", tables.doc_table)
    add("ids", "tw_tweet", tables.twhin_tweet)
    add("ids", "media_clip", tables.media_clip)
    add("ids", "text_emb", tables.text_emb)
    add("authors", "tw_author", tables.twhin_author)
    add("authors", "tw_author_follow", tables.twhin_author_follow)
    add("authors", "author_agg_emb", tables.author_agg_emb)
    add("clip", "tweepcred", tables.tweepcred, A_m)
    if A_m2 == A_m:
        add("clip", "author_meta", tables.author_meta, A_m)
    add("uid", "rg_nbrs", tables.rg_nbr_ids)
    add("uid", "rg_counts", tables.rg_counts)
    add("uid", "rg_last", tables.rg_last_ts)
    add("uid", "tw_user", tables.twhin_user)
    add("uid", "tw_user_neg", tables.twhin_user_negative)
    add("uid", "eng_ids", tables.eng_ids)
    add("uid", "eng_type", tables.eng_type)
    add("uid", "eng_ts", tables.eng_ts)
    add("uid", "eng_valid", tables.eng_valid)
    add("uid", "user_interests", tables.user_interests)
    add("uid", "uss_ids", tables.uss_ids)
    add("uid", "uss_ts", tables.uss_ts)
    # GFS adjacency per canonical pair ([E_ent, U, D]: the entity slice is a
    # static index, the U axis the keyed one)
    for name, (ue, ce) in graph_features.FEATURE_PAIRS.items():
        add("uid", f"gfs_a::{name}", tables.gfs_neighbors[int(ue)], U_g)
        add("clip", f"gfs_b::{name}", tables.gfs_neighbors[int(ce)], U_g)
    return plan


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """A table as [rows, width] (1-D and 3-D rows flattened)."""
    return t.reshape(t.shape[0], -1)


# the multiget lives with the kernel it launches (the sharded table's owner
# gather takes it too); these names stay for the hydration tier's callers
_ring_rows = gather_ops.ring_rows
launch_groups = gather_ops.launch_groups
multiget = gather_ops.multiget


def gather_rows(
    tables: DeviceWideTables,
    req: DeviceRequests,
    *,
    gather: Optional[Callable] = None,
    caps: Optional[Dict[str, int]] = None,
    agg_packed: Optional[AggPacked] = None,
) -> Dict[str, Any]:
    """Resolve every keyed table row the assembly math needs.

    ``gather(group, key)`` fetches rows for one key array from a dict of
    same-row-count tables (``{name: [rows, ...]}`` → ``{name: key.shape +
    ...}``); default :func:`multiget`. Keys are JAX's: ``% cap`` in floor-mod
    semantics (``torch.remainder``), so author -1 and PAD ids read rows in
    range.

    ``caps``: the logical row counts the keys are taken modulo (the sharded
    engine's tables hold local shards); default each table's ``shape[0]``.

    ``agg_packed`` (``tables.agg_packed``): every candidate- and
    viewer-keyed store row in ONE gather call (two launches: the 16-byte
    value rows and the 4-byte timestamps) instead of 18.
    """
    gather = gather or multiget
    ids, authors, uid = req.cand_ids, req.author_ids, req.uid
    rows: Dict[str, Any] = {}
    A_m = _cap_of(caps, "tweepcred", tables.tweepcred)
    A_m2 = _cap_of(caps, "author_meta", tables.author_meta)
    clip_a = torch.clamp(authors, min=0)
    flavors = {
        "ids": lambda cap: torch.remainder(ids, cap),
        "authors": lambda cap: torch.remainder(authors, cap),
        "clip": lambda cap: torch.remainder(clip_a, cap),
        "uid": lambda cap: torch.remainder(uid, cap),
    }
    for (flavor, cap), group in keyed_table_plan(tables, caps).items():
        rows.update(gather(group, flavors[flavor](cap)))
    if A_m2 != A_m:
        rows.update(gather({"author_meta": tables.author_meta}, torch.remainder(torch.remainder(clip_a, A_m), A_m2)))
    rows["gfs_a"] = {n: rows.pop(f"gfs_a::{n}") for n in graph_features.FEATURE_PAIRS}
    rows["gfs_b"] = {n: rows.pop(f"gfs_b::{n}") for n in graph_features.FEATURE_PAIRS}

    # aggregate stores: host-resolved row indices (-1 = miss; gather at
    # max(rows, 0), the expose masks)
    S, V = len(CAND_KEYED_AGG), len(VIEWER_KEYED_AGG)
    if agg_packed is not None:
        off = agg_packed.offsets
        keys_c = torch.clamp(req.agg_rows, min=0) + off[:S]  # [R, PB, S]
        keys_v = torch.clamp(req.viewer_agg_rows, min=0) + off[S:]  # [R, V]
        got = gather({"av": agg_packed.values, "al": agg_packed.last_ts},
                     torch.cat([keys_c.reshape(-1), keys_v.reshape(-1)]))
        n_c = keys_c.numel()
        vals_c = got["av"][:n_c].reshape(keys_c.shape + (-1,))
        last_c = got["al"][:n_c].reshape(keys_c.shape)
        vals_v = got["av"][n_c:].reshape(keys_v.shape + (-1,))
        last_v = got["al"][n_c:].reshape(keys_v.shape)
        rows["agg_cand_vals"] = tuple(vals_c[:, :, si] for si in range(S))
        rows["agg_cand_last"] = tuple(last_c[:, :, si] for si in range(S))
        rows["agg_viewer_vals"] = tuple(vals_v[:, vi] for vi in range(V))
        rows["agg_viewer_last"] = tuple(last_v[:, vi] for vi in range(V))
    else:
        cand = [gather({"v": tables.agg_values[si], "l": tables.agg_last_ts[si]},
                       torch.clamp(req.agg_rows[:, :, si], min=0)) for si in range(S)]
        viewer = [gather({"v": tables.agg_values[S + vi], "l": tables.agg_last_ts[S + vi]},
                         torch.clamp(req.viewer_agg_rows[:, vi], min=0)) for vi in range(V)]
        rows["agg_cand_vals"] = tuple(g["v"] for g in cand)
        rows["agg_cand_last"] = tuple(g["l"] for g in cand)
        rows["agg_viewer_vals"] = tuple(g["v"] for g in viewer)
        rows["agg_viewer_last"] = tuple(g["l"] for g in viewer)

    # replicated parameters the math phase needs
    rows["rg_w"] = tables.rg_w
    rows["rg_b"] = tables.rg_b
    return rows


def assemble_from_rows(
    rows: Dict[str, Any],
    fns: DeviceFns,
    req: DeviceRequests,
    *,
    n_sources: int,
    eng_rows: int,
    sc_buckets: int = 64,
) -> torch.Tensor:
    """[R, PB, total_width(WIDE_SCHEMA)] from pre-gathered rows: pure
    per-candidate math, no table indexing. ``eng_rows``: the engagement
    table's row count (the viewer InterestedIn fixture keys on it)."""
    R, PB = req.cand_ids.shape
    ids, authors = req.cand_ids, req.author_ids
    now_c = req.now[:, None]  # [R, 1]
    pieces: List[torch.Tensor] = []

    def emit(x):
        pieces.append(x if x.dim() == 3 else x[..., None])

    def per_request(x):  # [R, W] → broadcast over the candidate slots
        return x[:, None, :].expand(R, PB, x.shape[-1])

    # 1. earlybird doc features [R, PB, n_doc]
    emit(rows["doc"])

    # 2. realgraph viewer→author edge block
    nbrs = rows["rg_nbrs"]  # [R, D]
    dt = torch.clamp(req.now - rows["rg_last"], min=0).float()  # [R]
    decay = torch.exp2(-dt / realgraph.DEFAULT_HALF_LIFE_S)
    decayed = rows["rg_counts"] * decay[:, None, None]  # [R, D, Fr]
    match = (authors[:, :, None] == nbrs[:, None, :]).float()  # [R, PB, D]
    feats = torch.bmm(match, decayed)  # [R, PB, Fr]
    # the RealGraph edge model: sigmoid(log1p(f)·w + b) (realgraph.predict_edge_scores)
    p = realgraph.predict_edge_scores({"w": rows["rg_w"], "b": rows["rg_b"]}, feats)
    has_edge = match.sum(dim=2) > 0
    days = (dt / 86400.0)[:, None]  # [R, 1]
    emit(feats)
    emit(torch.where(has_edge, days, 0.0))
    emit(feats.sum(dim=-1))
    emit(torch.where(has_edge, p, 0.0))

    # 3. twhin blocks (5 × 64)
    emit(per_request(rows["tw_user"]))
    emit(rows["tw_author"])
    emit(rows["tw_tweet"])
    emit(per_request(rows["tw_user_neg"]))
    emit(rows["tw_author_follow"])

    # 4. RSX engagement-similarity block (kind × window × signal × agg)
    cand_cl, cand_sc = fns.tweet_emb(ids)  # [R, PB, K]
    eng_cl, eng_sc = fns.tweet_emb(rows["eng_ids"])  # [R, E, K]
    emit(_rsx_block(cand_cl, cand_sc, eng_cl, eng_sc, rows["eng_type"], now_c - rows["eng_ts"],
                    rows["eng_valid"] != 0))

    # 5. simclusters projections: viewer InterestedIn then candidate tweet
    ii_cl, ii_sc = fns.tweet_emb(torch.remainder(req.uid, eng_rows))  # [R, K]
    emit(per_request(_bucket_proj(ii_cl, ii_sc, sc_buckets)))
    emit(_bucket_proj(cand_cl, cand_sc, sc_buckets))

    # 6. large embeddings
    emit(per_request(rows["user_interests"]))
    emit(rows["author_agg_emb"])
    emit(rows["media_clip"])
    emit(rows["text_emb"])

    # 7. aggregate groups (schema prefix order)
    cand_store_idx = {n: i for i, n in enumerate(CAND_KEYED_AGG)}
    viewer_store_idx = {n: i for i, n in enumerate(VIEWER_KEYED_AGG)}
    for prefix in AGG_SCHEMA_ORDER:
        if prefix in cand_store_idx:
            si = cand_store_idx[prefix]
            emit(_agg_expose_rows(rows["agg_cand_vals"][si], rows["agg_cand_last"][si],
                                  req.agg_rows[:, :, si], now_c))  # [R, PB, L*H*5]
        else:
            vi = viewer_store_idx[prefix]
            emit(per_request(_agg_expose_rows(rows["agg_viewer_vals"][vi], rows["agg_viewer_last"][vi],
                                              req.viewer_agg_rows[:, vi], req.now)))

    # 8. USS signal counts per window × signal (broadcast)
    t_ids, t_ts = rows["uss_ids"], rows["uss_ts"]  # [R, S, W]
    cutoffs = req.now[:, None] - torch.tensor(USS_WINDOWS_S, dtype=torch.int32, device=t_ts.device)  # [R, 3]
    counts = ((t_ids != PAD_ID)[:, None] & (t_ts[:, None] >= cutoffs[:, :, None, None])).sum(dim=-1).float()
    emit(per_request(counts.reshape(R, -1)))  # [R, 3·S]

    # 9. GFS intersections (count + normalized per canonical pair)
    gfs_cols = []
    for name in graph_features.FEATURE_PAIRS:
        a_row = rows["gfs_a"][name]  # [R, D]
        cnt = graph_features.intersection_count(a_row[:, None, :], rows["gfs_b"][name]).float()  # [R, PB]
        deg = (a_row != PAD_ID).sum(dim=1).float()[:, None]  # [R, 1]
        gfs_cols += [cnt, cnt / torch.clamp(deg, min=1.0)]
    emit(torch.stack(gfs_cols, dim=-1))

    # 10. author meta + follow relations
    ok = (authors >= 0).float()
    emit(rows["tweepcred"] * ok)
    emit(rows["author_meta"] * ok[..., None])
    follows_match = ((authors[:, :, None] == req.follows[:, None, :])
                     & (req.follows != PAD_ID)[:, None, :]).any(dim=2).float()
    emit(follows_match)
    emit(fns.author_follows_viewer(req.uid[:, None], authors).float() * ok)

    # 11. context features lifted from the candidate object model
    emit(req.lift)  # [R, PB, 6] in CONTEXT_FEATURES order

    # 12. serving-context one-hots + scalars (broadcast)
    emit(per_request(_one_hot(req.ctx_hour, 24)))
    emit(per_request(_one_hot(req.ctx_dow, 7)))
    emit(per_request(_one_hot(req.ctx_client, fs.CONTEXT_CLIENTS)))
    emit(per_request(req.ctx_scalars))

    # 13. source one-hot (an unknown source, -1, is all zeros)
    emit(_one_hot(req.source_idx, n_sources))

    return torch.cat(pieces, dim=-1)


def assemble(
    tables: DeviceWideTables,
    fns: DeviceFns,
    req: DeviceRequests,
    *,
    n_sources: int,
    sc_buckets: int = 64,
    gather: Optional[Callable] = None,
    agg_packed: Optional[AggPacked] = None,
) -> torch.Tensor:
    """[R, PB, total_width(WIDE_SCHEMA)] — :func:`gather_rows` then
    :func:`assemble_from_rows`."""
    rows = gather_rows(tables, req, gather=gather, agg_packed=agg_packed)
    return assemble_from_rows(rows, fns, req, n_sources=n_sources, eng_rows=tables.eng_ids.shape[0],
                              sc_buckets=sc_buckets)


def _rsx_block(cand_cl, cand_sc, eng_cl, eng_sc, eng_type, eng_age, valid) -> torch.Tensor:
    """[R, PB, n_rsx] — kind × window × signal × (avg, max, min), matching
    ``rsx.engagement_similarity_features`` column order. Candidates are
    [R, PB, K], engagements [R, E, K] (their cluster rows as the formula
    gives them: unsorted, repeats kept), ``eng_type``/``eng_age``/``valid``
    [R, E]."""
    R, PB = cand_cl.shape[:2]
    cand = sparse.SparseEmbedding(cand_cl, cand_sc)
    eng = sparse.SparseEmbedding(eng_cl, eng_sc)
    windows = torch.tensor(list(rsx.WINDOWS_S.values()), dtype=eng_age.dtype, device=eng_age.device)
    signals = torch.arange(len(rsx.SIGNAL_TYPES), dtype=eng_type.dtype, device=eng_type.device)
    in_w = valid[:, None, :] & (eng_age[:, None, :] <= windows[None, :, None])  # [R, windows, E]
    m = in_w[:, :, None, :] & (eng_type[:, None, None, :] == signals[None, None, :, None])
    m = m.reshape(R, 1, -1, m.shape[-1])  # [R, 1, windows·signals, E]
    cols = []
    for kind in rsx.SIMILARITY_KINDS:
        sim = sparse.pairwise_matrix(rsx.KIND_FNS[kind], cand, eng)  # [R, PB, E]
        cols.append(torch.stack(rsx.masked_aggregates(sim[:, :, None, :], m), dim=-1).reshape(R, PB, -1))
    return torch.cat(cols, dim=-1)


def diversity_select(
    combined: torch.Tensor,  # [R, PB] combined scores
    author_ids: torch.Tensor,  # [R, PB] (-1 = unknown)
    cand_ids: torch.Tensor,  # [R, PB] (PAD_ID = empty slot)
    k: int,
    *,
    decay: float = 0.5,
    floor: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Author-diversity rescore + top-K on the device → (sel_idx [R, k],
    sel_ids [R, k], sel_scores [R, k]).

    The batched twin of ``BatchedForYouEngine._rescore_select``: rank by
    combined score (stable), decay each author's n-th appearance by
    decay**n (floored), re-rank in ``lax.top_k``'s order, take K.
    """
    R, PB = combined.shape
    valid = cand_ids != PAD_ID
    masked = torch.where(valid, combined, -torch.inf)
    order = torch.sort(-masked, dim=1, stable=True).indices  # [R, PB] ranked positions
    a_ranked = torch.gather(author_ids, 1, order)
    # occurrence index of each author within the ranked list: stable-sort
    # the ranked authors, count run positions, invert
    a_sorted, by_author = torch.sort(a_ranked, dim=1, stable=True)
    new_run = torch.ones_like(a_sorted, dtype=torch.bool)
    new_run[:, 1:] = a_sorted[:, 1:] != a_sorted[:, :-1]
    pos = torch.arange(PB, device=combined.device).expand(R, PB)
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=1).values
    occ = torch.empty_like(by_author).scatter_(1, by_author, pos - run_start)
    factor = torch.clamp(torch.pow(decay, occ.float()), min=floor)
    factor = torch.where(a_ranked >= 0, factor, 1.0)
    rescored = torch.gather(masked, 1, order) * factor
    rescored = torch.where(torch.gather(valid, 1, order), rescored, -torch.inf)
    sel_scores, sel = retrieval.top_k(rescored, k)
    sel_idx = torch.gather(order, 1, sel)
    sel_ids = torch.where(torch.isfinite(sel_scores), torch.gather(cand_ids, 1, sel_idx), PAD_ID)
    return sel_idx, sel_ids, sel_scores


# -- host-side request building (a copy of the JAX package's) ------------------


class HostRequestBuilder:
    """Per-request id→row resolution (the memcache-key layer kept on host).

    Produces the int32 index arrays of :class:`DeviceRequests` from the
    pipeline's (query, candidates), as numpy.
    """

    def __init__(
        self,
        resolvers: Dict[str, aggregation.KeyResolver],
        source_names: Optional[Sequence[str]] = None,
        pad_b: int = 512,
        follow_width: int = 64,
    ):
        self.resolvers = resolvers
        names = tuple(source_names) if source_names is not None else tuple(fs.candidate_source_names())
        self.source_index = {n: i for i, n in enumerate(names)}
        self.n_sources = len(names)
        self.pad_b = pad_b
        self.follow_width = follow_width

    def _cand_feature(self, candidates, feat, default_feat=None):
        out = []
        for c in candidates:
            v = c.features.get(feat)
            if v is None and default_feat is not None:
                v = c.features.get(default_feat)
            out.append(int(v) if v is not None else -1)
        return out

    def _viewer(self, query, uid: int, now: int):
        """The per-request fields: viewer store rows, follows, context."""
        viewer_keys = {
            "user_agg": (uid,),
            "user_list_agg": (uid, int(getattr(query, "list_id", -1) or -1)),
            "user_dow_agg": (uid, (now // 86400) % 7),
            "user_hour_agg": (uid, (now // 3600) % 24),
        }
        viewer_rows = np.empty(len(VIEWER_KEYED_AGG), np.int32)
        for vi, name in enumerate(VIEWER_KEYED_AGG):
            viewer_rows[vi] = self.resolvers[name].lookup([viewer_keys[name]])[0]
        follows = np.full(self.follow_width, PAD_ID, np.int32)
        fl = sorted(int(a) for a in getattr(query, "followed_authors", ()))
        follows[:min(len(fl), self.follow_width)] = fl[:self.follow_width]
        served = len(getattr(query, "served_tweet_ids", ()) or ())
        refresh = int(getattr(query, "refresh_count", 0) or 0)
        session_age = float(getattr(query, "session_age_s", 0) or 0) / 60.0
        ctx_scalars = np.asarray([
            float(getattr(query, "since_id", None) is None and getattr(query, "max_id", None) is None
                  and served == 0),
            float(np.log1p(refresh)),
            float(np.log1p(session_age)),
            float(served),
        ], np.float32)
        return dict(
            viewer_agg_rows=viewer_rows[None],
            uid=np.asarray([uid], np.int32),
            now=np.asarray([now], np.int32),
            follows=follows[None],
            ctx_hour=np.asarray([(now // 3600) % 24], np.int32),
            ctx_dow=np.asarray([(now // 86400) % 7], np.int32),
            ctx_client=np.asarray([int(getattr(query, "client_id", 0) or 0) % fs.CONTEXT_CLIENTS], np.int32),
            ctx_scalars=ctx_scalars[None],
        )

    def build(self, query, candidates) -> DeviceRequests:
        """One request → single-row (R=1) DeviceRequests (batch with
        :func:`batch_requests`)."""
        PB = self.pad_b
        cands = candidates[:min(len(candidates), PB)]
        uid = int(getattr(query, "user_id", 0))
        now = int(getattr(query, "now", 0))

        ids = np.full(PB, PAD_ID, np.int32)
        authors = np.full(PB, -1, np.int32)
        lift = np.zeros((PB, len(fs.CONTEXT_FEATURES)), np.float32)
        src = np.full(PB, -1, np.int32)
        for i, c in enumerate(cands):
            ids[i] = c.id
            a = c.features.get("author_id")
            authors[i] = int(a) if a is not None else -1
            for j, n in enumerate(fs.CONTEXT_FEATURES):
                v = c.features.get(n)
                if v is not None:
                    lift[i, j] = float(v)
            s = self.source_index.get(str(c.source))
            if s is not None:
                src[i] = s

        agg_rows = np.full((PB, len(CAND_KEYED_AGG)), -1, np.int32)
        key_lists = self._agg_keys(cands, uid, ids, authors)
        for si, name in enumerate(CAND_KEYED_AGG):
            r = self.resolvers[name].lookup(key_lists[name])
            agg_rows[:len(r), si] = r
        return DeviceRequests(cand_ids=ids[None], author_ids=authors[None], agg_rows=agg_rows[None],
                              lift=lift[None], source_idx=src[None], **self._viewer(query, uid, now))

    def build_columnar(self, query, cols: Dict[str, np.ndarray], n: int) -> DeviceRequests:
        """Columnar twin of :meth:`build` — per-candidate data arrives as
        numpy columns, so no per-candidate Python executes. ``cols`` must
        carry ``ids``; other recognized columns: author_id, topic_id,
        language_id, media_type, conversation_id, engager_id,
        mentioned_user_id, original_author_id, the CONTEXT_FEATURES,
        source_idx, source_hash (absent → defaults)."""
        PB = self.pad_b
        B = min(n, PB)
        uid = int(getattr(query, "user_id", 0))
        now = int(getattr(query, "now", 0))

        def col(name, default, dtype=np.int64):
            v = cols.get(name)
            if v is None:
                return np.full(B, default, dtype)
            return np.asarray(v[:B], dtype)

        ids_c = col("ids", PAD_ID)
        ids = np.full(PB, PAD_ID, np.int32)
        ids[:B] = ids_c
        author_c = col("author_id", -1)
        authors = np.full(PB, -1, np.int32)
        authors[:B] = author_c

        lift = np.zeros((PB, len(fs.CONTEXT_FEATURES)), np.float32)
        for j, name in enumerate(fs.CONTEXT_FEATURES):
            v = cols.get(name)
            if v is not None:
                lift[:B, j] = np.asarray(v[:B], np.float32)

        src = np.full(PB, -1, np.int32)
        if "source_idx" in cols:
            src[:B] = np.asarray(cols["source_idx"][:B], np.int32)

        # vectorized store-row resolution (one searchsorted per store)
        uid_col = np.full(B, uid, np.int64)
        topic = col("topic_id", -1)
        orig_author = cols.get("original_author_id")
        orig = np.asarray(orig_author[:B], np.int64) if orig_author is not None else author_c
        key_cols = {
            "tweet_agg": (ids_c, None),
            "author_agg": (author_c, None),
            "user_author_agg": (uid_col, author_c),
            "user_author_oon_agg": (uid_col, author_c),
            "user_engager_agg": (uid_col, col("engager_id", -1)),
            "user_mention_agg": (uid_col, col("mentioned_user_id", -1)),
            "user_original_author_agg": (uid_col, orig),
            "user_topic_agg": (uid_col, topic),
            "author_topic_agg": (author_c, topic),
            "user_source_agg": (uid_col, col("source_hash", -1)),
            "user_language_agg": (uid_col, col("language_id", -1)),
            "user_media_agg": (uid_col, col("media_type", -1)),
            "user_conversation_agg": (uid_col, col("conversation_id", -1)),
            "topic_agg": (topic, None),
        }
        agg_rows = np.full((PB, len(CAND_KEYED_AGG)), -1, np.int32)
        for si, name in enumerate(CAND_KEYED_AGG):
            k0, k1 = key_cols[name]
            agg_rows[:B, si] = self.resolvers[name].lookup_vec(k0, k1)
        return DeviceRequests(cand_ids=ids[None], author_ids=authors[None], agg_rows=agg_rows[None],
                              lift=lift[None], source_idx=src[None], **self._viewer(query, uid, now))

    def _agg_keys(self, cands, uid, ids, authors):
        """Key tuples per candidate-keyed store (hydrator key semantics)."""
        B = len(cands)
        topic = self._cand_feature(cands, "topic_id")
        return {
            "tweet_agg": [(int(i),) for i in ids[:B]],
            "author_agg": [(int(a),) for a in authors[:B]],
            "user_author_agg": [(uid, int(a)) for a in authors[:B]],
            "user_author_oon_agg": [(uid, int(a)) for a in authors[:B]],
            "user_engager_agg": [(uid, v) for v in self._cand_feature(cands, "engager_id")],
            "user_mention_agg": [(uid, v) for v in self._cand_feature(cands, "mentioned_user_id")],
            "user_original_author_agg": [
                (uid, v) for v in self._cand_feature(cands, "original_author_id", "author_id")],
            "user_topic_agg": [(uid, t) for t in topic],
            "author_topic_agg": [(int(a), t) for a, t in zip(authors[:B], topic)],
            "user_source_agg": [(uid, source_hash(c.source)) for c in cands],
            "user_language_agg": [(uid, v) for v in self._cand_feature(cands, "language_id")],
            "user_media_agg": [(uid, v) for v in self._cand_feature(cands, "media_type")],
            "user_conversation_agg": [(uid, v) for v in self._cand_feature(cands, "conversation_id")],
            "topic_agg": [(t,) for t in topic],
        }


def source_hash(source) -> int:
    """The ``user_source_agg`` key of a source name."""
    return zlib.crc32(str(source or "").encode()) % 1024


def batch_requests(reqs: Sequence[DeviceRequests]) -> DeviceRequests:
    """Stack R single-row requests into one [R, ...] batch."""
    return DeviceRequests(*(np.concatenate(xs, axis=0) for xs in zip(*reqs)))


_N_LIFT = len(fs.CONTEXT_FEATURES)


def pack_requests(req: DeviceRequests, compact_rows: bool = False) -> np.ndarray:
    """DeviceRequests (numpy) → ONE int32 [R, PB, W] upload buffer.

    Layout: cand int32 columns ‖ store rows ‖ bitcast(f32 lift) ‖ one
    metadata column whose leading rows carry the per-request ints (uid, now,
    hour, dow, client, viewer rows, follows) and, after them, the bitcast
    ctx scalars. Requires PB ≥ 5+V+FW+4.

    ``compact_rows``: the 14 store-row columns pack as int16 pairs in 7
    int32 lanes. Valid only when every aggregate store's capacity < 32768;
    the scorer checks and selects the format.
    """
    R, PB = req.cand_ids.shape
    S, V = len(CAND_KEYED_AGG), len(VIEWER_KEYED_AGG)
    FW = req.follows.shape[1]
    n_meta = 5 + V + FW + 4
    if PB < n_meta:
        raise ValueError(f"pad_b={PB} < metadata rows {n_meta}")
    SW = S // 2 if compact_rows else S  # packed width of the row block
    W = 3 + SW + _N_LIFT + 1
    out = np.zeros((R, PB, W), np.int32)  # the metadata column's rows past n_meta stay 0
    out[..., 0] = req.cand_ids
    out[..., 1] = req.author_ids
    out[..., 2] = req.source_idx
    if compact_rows:
        out[..., 3:3 + SW] = (np.ascontiguousarray(req.agg_rows, np.int32)
                              .astype(np.int16).reshape(R, PB, SW, 2).view(np.int32)[..., 0])
    else:
        out[..., 3:3 + SW] = req.agg_rows
    out[..., 3 + SW:3 + SW + _N_LIFT] = np.ascontiguousarray(req.lift, np.float32).view(np.int32)
    meta = out[..., -1]
    meta[:, 0] = req.uid
    meta[:, 1] = req.now
    meta[:, 2] = req.ctx_hour
    meta[:, 3] = req.ctx_dow
    meta[:, 4] = req.ctx_client
    meta[:, 5:5 + V] = req.viewer_agg_rows
    meta[:, 5 + V:5 + V + FW] = req.follows
    meta[:, 5 + V + FW:n_meta] = np.ascontiguousarray(req.ctx_scalars, np.float32).view(np.int32)
    return out


def unpack_requests(packed: torch.Tensor, follow_width: int, compact_rows: bool = False) -> DeviceRequests:
    """Inverse of :func:`pack_requests` on the device: slices and bitcasts
    of one int32 [R, PB, W] tensor."""
    S, V = len(CAND_KEYED_AGG), len(VIEWER_KEYED_AGG)
    FW = follow_width
    SW = S // 2 if compact_rows else S
    meta = packed[..., -1]

    def f32(x):
        return x.contiguous().view(torch.float32)

    if compact_rows:  # each int32 lane holds two int16 rows, low half first
        agg_rows = packed[..., 3:3 + SW].contiguous().view(torch.int16).to(torch.int32)
    else:
        agg_rows = packed[..., 3:3 + SW]
    return DeviceRequests(
        cand_ids=packed[..., 0], author_ids=packed[..., 1], source_idx=packed[..., 2], agg_rows=agg_rows,
        lift=f32(packed[..., 3 + SW:3 + SW + _N_LIFT]),
        uid=meta[:, 0], now=meta[:, 1], ctx_hour=meta[:, 2], ctx_dow=meta[:, 3], ctx_client=meta[:, 4],
        viewer_agg_rows=meta[:, 5:5 + V], follows=meta[:, 5 + V:5 + V + FW],
        ctx_scalars=f32(meta[:, 5 + V + FW:5 + V + FW + 4]),
    )


def build_from_world(world: Dict, device_spec: Dict):
    """(DeviceWideTables, DeviceFns, resolvers) from
    :func:`~the_algorithm_tpu_torch.mixers.wide_hydrators.synthetic_world`'s
    world and its ``device_spec``, on the world's device, the aggregate
    stores packed (:func:`pack_agg_stores`)."""
    def store_of(name):
        if name in ("tweet_agg", "author_agg", "user_agg"):
            return world[name]
        return world["pair_aggs"][name]

    agg_values, agg_last_ts, resolvers = [], [], {}
    for name in (*CAND_KEYED_AGG, *VIEWER_KEYED_AGG):
        store, resolver = store_of(name)
        agg_values.append(store.values)
        agg_last_ts.append(store.last_ts)
        resolvers[name] = resolver

    rg = world["realgraph_table"]
    sig = world["signal_store"]
    eng_ids = device_spec["eng_ids"]
    tables = pack_agg_stores(DeviceWideTables(
        doc_table=device_spec["doc_table"],
        rg_nbr_ids=rg.neighbor_ids,
        rg_counts=rg.counts,
        rg_last_ts=rg.last_ts,
        rg_w=world["realgraph_params"]["w"],
        rg_b=world["realgraph_params"]["b"],
        twhin_user=world["twhin_user"],
        twhin_author=world["twhin_author"],
        twhin_tweet=world["twhin_tweet"],
        twhin_user_negative=world["twhin_user_negative"],
        twhin_author_follow=world["twhin_author_follow"],
        eng_ids=eng_ids,
        eng_type=device_spec["eng_types"],
        eng_ts=device_spec["eng_ts"],
        eng_valid=torch.ones_like(eng_ids),
        user_interests=world["user_interests_table"],
        author_agg_emb=world["author_agg_table"],
        media_clip=world["media_cluster_table"],
        text_emb=world["text_embedding_table"],
        agg_values=tuple(agg_values),
        agg_last_ts=tuple(agg_last_ts),
        uss_ids=sig.target_ids,
        uss_ts=sig.timestamps,
        gfs_neighbors=world["gfs_tables"].neighbors,
        tweepcred=world["tweepcred"],
        author_meta=world["author_meta"],
    ))
    fns = DeviceFns(tweet_emb=device_spec["tweet_emb_device"],
                    author_follows_viewer=device_spec["author_follows_viewer_device"])
    return tables, fns, resolvers


# -- the fused hydrate+score engine -------------------------------------------


class DeviceHydrationScorer:
    """Wide hydration + MaskNet scoring, one pass over each request batch on
    the tables' device.

    ``score_requests([(query, candidates), ...])`` returns per-request
    ``(probs [B_i, H], combined [B_i])`` with the feature matrix never
    leaving the device. The JAX package takes flax ``params`` beside the
    model; here ``model`` is a :class:`~the_algorithm_tpu_torch.models.masknet.MaskNet`
    on the tables' device holding its weights (None: assembly only).
    Features are cast to ``compute_dtype`` before the model, as the JAX
    package's scorer casts them.
    """

    def __init__(
        self,
        tables: DeviceWideTables,
        fns: DeviceFns,
        resolvers: Dict[str, aggregation.KeyResolver],
        model: Optional[torch.nn.Module],
        head_weights,
        *,
        pad_b: int = 512,
        source_names: Optional[Sequence[str]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        select_top_k: Optional[int] = None,
        diversity_decay: float = 0.5,
        diversity_floor: float = 0.25,
    ):
        self.builder = HostRequestBuilder(resolvers, source_names=source_names, pad_b=pad_b)
        self.tables = tables
        self.fns = fns
        self.device = tables.doc_table.device
        self.model = model
        self.head_weights = None if head_weights is None else torch.as_tensor(
            head_weights, dtype=torch.float32).to(self.device)
        self.compute_dtype = compute_dtype
        # compact int16 row packing when every store's capacity fits
        self._compact_rows = all(int(v.shape[0]) < 32768 for v in tables.agg_values)
        self.select_top_k = select_top_k
        self.diversity_decay = diversity_decay
        self.diversity_floor = diversity_floor

    def _assemble(self, req: DeviceRequests, tables: DeviceWideTables) -> torch.Tensor:
        """The features of one batch from ONE snapshot of the tables: a
        writer (``live_updates.LiveUpdater``) swaps ``self.tables`` whole, so
        a batch reads ``self.tables`` once and passes that down."""
        return assemble(tables, self.fns, req, n_sources=self.builder.n_sources, agg_packed=tables.agg_packed)

    def _run(self, packed: torch.Tensor) -> torch.Tensor:
        """The device pass over one packed batch: [R, PB, H+1] (probs ‖
        combined), or with ``select_top_k`` [R, K, H+2] (probs ‖ score ‖
        bitcast id) — one array, so one fetch."""
        tables = self.tables  # this batch's snapshot
        with torch.inference_mode():
            req = unpack_requests(packed, self.builder.follow_width, compact_rows=self._compact_rows)
            x = self._assemble(req, tables)
            R, PB, F = x.shape
            probs = torch.sigmoid(self.model(x.reshape(R * PB, F).to(self.compute_dtype)))
            probs = probs.reshape(R, PB, -1).float()
            combined = masknet.weighted_model_score(probs, self.head_weights)
            if self.select_top_k is None:
                return torch.cat([probs, combined[..., None]], dim=-1)
            sel_idx, sel_ids, sel_scores = diversity_select(
                combined, req.author_ids, req.cand_ids, self.select_top_k,
                decay=self.diversity_decay, floor=self.diversity_floor)
            sel_probs = torch.gather(probs, 1, sel_idx[..., None].expand(-1, -1, probs.shape[-1]))
            return torch.cat([sel_probs, sel_scores[..., None], sel_ids.view(torch.float32)[..., None]], dim=-1)

    def _fetch(self, reqs: Sequence[DeviceRequests]) -> np.ndarray:
        packed = pack_requests(batch_requests(reqs), compact_rows=self._compact_rows)
        return self._run(torch.from_numpy(packed).to(self.device)).cpu().numpy()  # one upload, one fetch

    def assemble_features(self, query, candidates) -> np.ndarray:
        """[B, F] device-assembled feature matrix (parity/debug path)."""
        req = self.builder.build(query, candidates)
        with torch.inference_mode():
            x = self._assemble(DeviceRequests(*(torch.from_numpy(a).to(self.device) for a in req)), self.tables)
        return x[0, :len(candidates)].cpu().numpy()

    def score_requests(self, batch):
        """batch: [(query, candidates), ...] → [(probs, combined), ...]."""
        out = self._fetch([self.builder.build(q, c) for q, c in batch])
        return [(out[i, :min(len(c), out.shape[1]), :-1], out[i, :min(len(c), out.shape[1]), -1])
                for i, (_, c) in enumerate(batch)]

    def score_columnar(self, batch):
        """batch: [(query, cols, n), ...] (columnar candidates) →
        [(probs [n, H], combined [n]), ...] — the zero-object hot path."""
        if self.select_top_k is not None:
            raise RuntimeError("scorer built with select_top_k: use select_columnar")
        out = self._fetch([self.builder.build_columnar(q, cols, n) for q, cols, n in batch])
        return [(out[i, :min(n, out.shape[1]), :-1], out[i, :min(n, out.shape[1]), -1])
                for i, (_, _, n) in enumerate(batch)]

    def select_columnar(self, batch):
        """Device-selected path: [(query, cols, n), ...] →
        [(sel_ids [K], sel_scores [K], sel_probs [K, H]), ...]."""
        if self.select_top_k is None:
            raise RuntimeError("scorer built without select_top_k: use score_columnar")
        out = self._fetch([self.builder.build_columnar(q, cols, n) for q, cols, n in batch])
        probs, scores = out[..., :-2], out[..., -2]
        ids = np.ascontiguousarray(out[..., -1]).view(np.int32)
        res = []
        for i in range(len(batch)):
            ok = np.isfinite(scores[i])
            res.append((ids[i][ok], scores[i][ok], probs[i][ok]))
        return res

"""The SimClusters world of ``bench.py``'s retrieval tier, drawn in torch
on the device from a seed.

The draws follow ``data/sann_world.py`` of the port (``bench.py:98-138,
822-831``) in kind, not draw for draw: communities partition the C clusters;
each community has ``n_pool`` distinct KT-subsets of its clusters; a tweet
takes one subset of a random community, with scores uniform in [0.1, 1);
each cluster's index row holds its top-M tweets by score (ties: the lower
tweet id first); a query takes N distinct clusters of one random community
with scores uniform in [0.2, 1). Every draw is one large call on the device,
so the 2M-tweet, 64M-entry world takes well under a second where numpy took
~46 s.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import torch

PAD_ID = 2**31 - 1  # int32 max: an empty index slot


@dataclasses.dataclass(frozen=True)
class SannShape:
    n_comm: int  # communities; they partition the clusters
    cpc: int  # clusters per community
    M: int  # tweets per cluster row of the index
    N: int  # scan clusters per query
    X: int  # results per query
    T: int  # tweet corpus
    KT: int  # clusters per tweet embedding
    n_pool: int = 256  # distinct KT-subsets per community

    @property
    def C(self) -> int:
        return self.n_comm * self.cpc


class SannWorld(NamedTuple):
    index_ids: torch.Tensor  # [C, M] int32, PAD_ID where the cluster has fewer tweets
    index_scores: torch.Tensor  # [C, M] float32, score-descending, 0 on PAD
    index_ts: torch.Tensor  # [C, M] int32 (0: no age window)
    comm_clusters: torch.Tensor  # [n_comm, cpc] int64


def shape_of(config: dict) -> SannShape:
    """The SANN shape a configuration file gives."""
    c = config
    return SannShape(n_comm=c["communities"], cpc=c["clusters_per_community"], M=c["M"], N=c["N"], X=c["X"],
                     T=c["T"], KT=c["KT"], n_pool=c["subsets_per_community"])


def build(shape: SannShape, gen: torch.Generator, device) -> SannWorld:
    s = shape
    comm_clusters = torch.randperm(s.C, generator=gen, device=device).reshape(s.n_comm, s.cpc)
    # each community's pool of KT-subsets: the first KT of a random order of its clusters
    keys = torch.rand((s.n_comm, s.n_pool, s.cpc), generator=gen, device=device).argsort(dim=-1)[..., : s.KT]
    pools = torch.gather(comm_clusters[:, None, :].expand(s.n_comm, s.n_pool, s.cpc), 2, keys)
    del keys
    tweet_comm = torch.randint(0, s.n_comm, (s.T,), generator=gen, device=device)
    pick = torch.randint(0, s.n_pool, (s.T,), generator=gen, device=device)
    ids = pools[tweet_comm, pick]  # [T, KT] distinct clusters per tweet
    del pools, tweet_comm, pick
    scores = torch.rand((s.T, s.KT), generator=gen, device=device) * 0.9 + 0.1
    # cluster -> its tweets, best score first, the lower tweet id first among ties
    flat_c = ids.reshape(-1)
    flat_s = scores.reshape(-1)
    flat_t = torch.arange(s.T, device=device).repeat_interleave(s.KT)
    del ids, scores
    order = torch.sort(flat_t, stable=True).indices  # already ascending: keeps tweet order
    order = order[torch.sort(-flat_s[order], stable=True).indices]
    order = order[torch.sort(flat_c[order], stable=True).indices]
    fc, fs, ft = flat_c[order], flat_s[order], flat_t[order]
    del order, flat_c, flat_s, flat_t
    start = torch.searchsorted(fc, torch.arange(s.C, device=device))
    rank = torch.arange(fc.numel(), device=device) - start[fc]
    keep = rank < s.M
    index_ids = torch.full((s.C, s.M), PAD_ID, dtype=torch.int32, device=device)
    index_scores = torch.zeros((s.C, s.M), dtype=torch.float32, device=device)
    index_ids[fc[keep], rank[keep]] = ft[keep].to(torch.int32)
    index_scores[fc[keep], rank[keep]] = fs[keep]
    index_ts = torch.zeros((s.C, s.M), dtype=torch.int32, device=device)
    return SannWorld(index_ids, index_scores, index_ts, comm_clusters)


def draw_queries(shape: SannShape, comm_clusters: torch.Tensor, Q: int, gen: torch.Generator,
                 device) -> List[torch.Tensor]:
    """Q community-flavoured InterestedIn queries: (ids [Q, N] int32, scores
    [Q, N] float32), N distinct clusters of one random community each."""
    s = shape
    q_comm = torch.randint(0, s.n_comm, (Q,), generator=gen, device=device)
    pick = torch.rand((Q, s.cpc), generator=gen, device=device).argsort(dim=-1)[:, : s.N]
    ids = torch.gather(comm_clusters[q_comm], 1, pick).to(torch.int32)
    scores = torch.rand((Q, s.N), generator=gen, device=device) * 0.8 + 0.2
    return [ids, scores]

"""Tweet-similarity offline model: co-engagement labels and pair features.

Counterpart of ``the_algorithm_tpu/simclusters/tweet_similarity.py``
(``scalding/tweet_similarity/TrainingDataCollectionJob.scala:22-158``:
positive pairs are two tweets engaged by one user within a co-engagement
window, negatives random pairs never co-engaged; and
``TweetPairFeatureHydrationUtil.scala``'s SimClusters pair features, the
same block at train and serve time).

Label collection is the JAX package's host numpy, copied (the same
``default_rng`` draws). The features broadcast over any batch shape; the
pair model is a small MLP whose parameters keep JAX's layout (``w{i}``
[in, out], ``b{i}``), trained with ``training/optimizers.Adam`` (optax's
arithmetic). It reads no table, so it launches no hand kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops import sparse
from the_algorithm_tpu_torch.ops.sparse import PAD_ID, SparseEmbedding


class TweetPairDataset(NamedTuple):
    """Labelled tweet pairs (host arrays, the offline job's output)."""

    tweet_a: np.ndarray  # [N] int64
    tweet_b: np.ndarray  # [N] int64
    label: np.ndarray  # [N] float32 (1 = co-engaged)


def collect_training_pairs(
    user_ids: np.ndarray,
    tweet_ids: np.ndarray,
    timestamps: np.ndarray,
    *,
    coengagement_window_s: int = 30 * 60,
    max_pairs_per_user: int = 10,
    negatives_per_positive: float = 1.0,
    seed: int = 0,
) -> TweetPairDataset:
    """The label-collection job (``TrainingDataCollectionJob.scala``).

    Positives: ordered co-engagement pairs (same user, |Δt| ≤ window),
    capped per user. Negatives: random tweet pairs that never co-occur for
    any user.
    """
    rng = np.random.default_rng(seed)
    order = np.lexsort((timestamps, user_ids))
    u, t, ts = user_ids[order], tweet_ids[order], timestamps[order]

    pos_a, pos_b = [], []
    coengaged = set()
    starts = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    ends = np.r_[starts[1:], len(u)]
    for s, e in zip(starts, ends):
        count = 0
        for i in range(s, e):
            for j in range(i + 1, e):
                if ts[j] - ts[i] > coengagement_window_s:
                    break
                if t[i] == t[j]:
                    continue
                key = (min(int(t[i]), int(t[j])), max(int(t[i]), int(t[j])))
                coengaged.add(key)
                if count < max_pairs_per_user:
                    pos_a.append(t[i])
                    pos_b.append(t[j])
                    count += 1

    n_pos = len(pos_a)
    n_neg = int(n_pos * negatives_per_positive)
    all_tweets = np.unique(tweet_ids)
    neg_a, neg_b = [], []
    while len(neg_a) < n_neg and len(all_tweets) >= 2:
        a, b = rng.choice(all_tweets, 2, replace=False)
        key = (min(int(a), int(b)), max(int(a), int(b)))
        if key in coengaged:
            continue
        neg_a.append(a)
        neg_b.append(b)

    return TweetPairDataset(
        np.asarray(pos_a + neg_a, np.int64),
        np.asarray(pos_b + neg_b, np.int64),
        np.concatenate([np.ones(n_pos, np.float32), np.zeros(len(neg_a), np.float32)]),
    )


FEATURE_NAMES = (
    "cosine", "dot", "log_cosine", "jaccard", "euclidean",
    "norm_a", "norm_b", "size_a", "size_b",
)


def pair_features(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """[..., len(FEATURE_NAMES)] features of each pair
    (``TweetPairFeatureHydrationUtil.getFeaturesFromTweetPair``)."""
    return torch.stack(
        [
            sparse.cosine(a, b),
            sparse.dot(a, b),
            sparse.log_norm_cosine(a, b),
            sparse.fuzzy_jaccard(a, b),
            sparse.euclidean(a, b),
            sparse.l2_norm(a),
            sparse.l2_norm(b),
            (a.ids != PAD_ID).sum(-1).to(torch.float32),
            (b.ids != PAD_ID).sum(-1).to(torch.float32),
        ],
        dim=-1,
    )


def pair_features_batch(a: SparseEmbedding, b: SparseEmbedding) -> torch.Tensor:
    """[B, F]: the JAX package's ``vmap`` of :func:`pair_features`, which
    broadcasts already."""
    return pair_features(a, b)


# -- the pair model ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TweetSimilarityModelConfig:
    hidden: Tuple[int, ...] = (32, 16)
    num_features: int = len(FEATURE_NAMES)


class TweetSimilarityModel(torch.nn.Module):
    """The pair MLP: tanh(0.1·x), then dense layers with ReLU between,
    ending in one logit. Parameters ``w{i}`` [in, out] and ``b{i}`` as JAX's
    ``init_params`` lays them out (He-normal weights, zero biases)."""

    def __init__(self, config: TweetSimilarityModelConfig = TweetSimilarityModelConfig(), *, seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve(device, "TweetSimilarityModel")
        g = torch.Generator().manual_seed(seed)  # drawn on the CPU: the same weights on any device
        dims = (config.num_features, *config.hidden, 1)
        self.n_layers = len(dims) - 1
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((din, dout), generator=g) * float(np.sqrt(2.0 / din))
            self.register_parameter(f"w{i}", torch.nn.Parameter(w.to(dev)))
            self.register_parameter(f"b{i}", torch.nn.Parameter(torch.zeros(dout, device=dev)))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """[B, F] → [B] similarity logits."""
        x = torch.tanh(features * 0.1) if features.dim() == 2 else features
        for i in range(self.n_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1:
                x = torch.relu(x)
        return x[:, 0]


def params_from_jax(model: TweetSimilarityModel, params: Dict) -> TweetSimilarityModel:
    """Load JAX's ``init_params`` dict (host arrays, ``w{i}`` [in, out])
    into ``model`` in place; returns it."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(params[name], np.float32)))
    return model


def loss_fn(model: TweetSimilarityModel, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Mean logistic loss in JAX's stable form."""
    logits = model(batch["features"])
    labels = batch["label"]
    loss = torch.mean(torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {}

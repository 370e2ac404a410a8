"""WALS (weighted alternating least squares) collaborative filtering.

Counterpart of ``the_algorithm_tpu/models/wals.py`` ≡ cr-mixer's
``similarity_engine/ConsumerBasedWalsSimilarityEngine.scala``: an
implicit-feedback matrix factorization over user↔tweet engagements
(Hu-Koren-Volinsky implicit ALS). At serve time the consumer embedding is
solved on the fly from the user's recent engaged tweets against the fixed
item factors (one d×d ridge solve), then similar tweets come from a dense
top-K against the item-factor table.

Each alternating half-step is a batch of d×d normal-equation solves
(``torch.linalg.solve`` over a leading batch dimension, where the JAX
package vmaps ``jnp.linalg.solve``; it has no Pallas kernel here), the
confidence-weighted Gram terms batched products taken ``ROWS`` rows at a
time. :func:`consumer_embedding` reads the history's factor rows through
``row_gather`` (JAX's index rule); :func:`similar_items` ranks through
``retrieval.top_k`` (``lax.top_k``'s order among equal scores).
:func:`model_from_jax` / :func:`model_to_jax` carry the factors across.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from the_algorithm_tpu_torch.core.device import resolve
from the_algorithm_tpu_torch.ops import retrieval
from the_algorithm_tpu_torch.ops.gather import jax_rows, row_gather

ROWS = 1 << 22  # entries of a half-step's [rows, d, N] confidence-weighted block at once, over d·N


@dataclasses.dataclass(frozen=True)
class WalsConfig:
    dim: int = 32
    reg: float = 0.1  # λ ridge
    alpha: float = 10.0  # implicit confidence: c = 1 + α·r
    iterations: int = 10


class WalsModel(NamedTuple):
    user_factors: torch.Tensor  # [U, d]
    item_factors: torch.Tensor  # [T, d]


def _solve_side(fixed: torch.Tensor, ratings: torch.Tensor, reg: float, alpha: float) -> torch.Tensor:
    """One ALS half-step: for every row m solve
    (FᵀF + Fᵀ(C_m−I)F + λI) x = Fᵀ C_m p_m (implicit ALS normal equations),
    ``fixed`` [N, d] the side held fixed, ``ratings`` [M, N]."""
    N, d = fixed.shape
    gram = fixed.T @ fixed  # [d, d] shared across rows
    eye = reg * torch.eye(d, dtype=fixed.dtype, device=fixed.device)
    out = []
    step = max(1, ROWS // max(d * N, 1))
    for s in range(0, ratings.shape[0], step):
        r = ratings[s:s + step]
        c_minus_1 = alpha * r  # [m, N]
        p = (r > 0).to(fixed.dtype)
        a = gram + (fixed.T[None] * c_minus_1[:, None, :]) @ fixed + eye  # [m, d, d]
        b = ((1.0 + c_minus_1) * p) @ fixed  # [m, d]
        out.append(torch.linalg.solve(a, b[..., None])[..., 0])
    return torch.cat(out) if out else fixed.new_zeros((0, d))


def train_wals(ratings: torch.Tensor, config: WalsConfig, *, item_init: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> WalsModel:
    """The full alternating optimization (the offline job) on ``ratings``'
    device. The item factors start from ``item_init`` [T, d] or 0.1·N(0, 1)
    drawn from ``generator`` (the user side's start is never read: the
    first half-step solves it). A final user half-step makes the user
    factors the solve against the returned item factors, so the serve-time
    ``consumer_embedding`` with the full Gram reproduces a training user's
    vector."""
    ratings = torch.as_tensor(ratings).float()
    T = ratings.shape[1]
    if item_init is None:
        y = torch.randn((T, config.dim), generator=generator, device=ratings.device) * 0.1
    else:
        y = torch.as_tensor(item_init, device=ratings.device).float()
    for _ in range(config.iterations):
        x = _solve_side(y, ratings, config.reg, config.alpha)
        y = _solve_side(x, ratings.T, config.reg, config.alpha)
    x = _solve_side(y, ratings, config.reg, config.alpha)
    return WalsModel(x, y)


def item_gram(item_factors: torch.Tensor) -> torch.Tensor:
    """YᵀY over the full corpus — precompute once per factor refresh."""
    return item_factors.T @ item_factors


def consumer_embedding(
    item_factors: torch.Tensor,  # [T, d]
    engaged_items: torch.Tensor,  # [H] int (history; padded < 0)
    engagement_weights: torch.Tensor,  # [H]
    reg: float = 0.1,
    alpha: float = 10.0,
    gram: Optional[torch.Tensor] = None,  # [d, d] item_gram(item_factors)
) -> torch.Tensor:
    """The serve-time consumer vector from the history (the on-the-fly WALS
    solve). With ``gram`` (YᵀY over the whole corpus) the solve is a
    training half-step for that user; without it the history-only Gram is a
    cheaper approximation. The history's factor rows come in one
    ``row_gather`` launch."""
    T, d = item_factors.shape
    dev = item_factors.device
    engaged = torch.as_tensor(engaged_items, device=dev)
    valid = engaged >= 0
    safe = torch.where(valid, engaged, 0)
    (f,) = row_gather(jax_rows(safe, T).to(torch.int32), item_factors.contiguous())
    f = f * valid[:, None]
    r = torch.where(valid, torch.as_tensor(engagement_weights, device=dev).to(f.dtype), 0.0)
    c_minus_1 = alpha * r
    base = gram if gram is not None else f.T @ f
    a = base + (f.T * c_minus_1) @ f + reg * torch.eye(d, dtype=f.dtype, device=dev)
    b = f.T @ ((1.0 + c_minus_1) * (r > 0))
    return torch.linalg.solve(a, b)


def similar_items(
    consumer_vec: torch.Tensor,  # [d]
    item_factors: torch.Tensor,  # [T, d]
    k: int,
    exclude: Optional[torch.Tensor] = None,  # [H] engaged items to drop
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense top-K against the factor table (one matvec): (item ids [k]
    int32, scores [k]), ``lax.top_k``'s order; excluded items score −inf.
    As ``lax.top_k``, a k past the items raises."""
    if k > item_factors.shape[0]:
        raise ValueError(f"top_k of k={k} over {item_factors.shape[0]} items")
    scores = item_factors @ consumer_vec
    if exclude is not None:
        ids = torch.arange(scores.shape[0], device=scores.device)
        scores = torch.where(torch.isin(ids, torch.as_tensor(exclude, device=scores.device)), float("-inf"), scores)
    top, idx = retrieval.top_k(scores.float(), k)
    return idx.to(torch.int32), top


def model_from_jax(model, device=None) -> WalsModel:
    """The JAX package's ``WalsModel`` (or any (user, item) factor pair of
    arrays) → this module's, f32 on ``device`` (default: the card)."""
    dev = resolve(device, "WalsModel")
    return WalsModel(*(torch.tensor(np.asarray(a, np.float32), device=dev) for a in model))


def model_to_jax(model: WalsModel) -> Tuple[np.ndarray, np.ndarray]:
    """The factors as f32 numpy arrays (user, item), the JAX ``WalsModel``'s
    fields in order."""
    return tuple(a.detach().to("cpu", torch.float32).numpy() for a in model)

"""Phoenix training in the port (the_algorithm_tpu_torch/models/phoenix.py's
batched forward and its gradient, through training/trainer.py) against the
JAX package: ``jax.vmap(model.apply)``, ``jax.grad`` of
``multi_action_loss``, the JAX ``Trainer``, and the JAX tests' AUC recipe
and serve → log → retrain loop (tests/test_phoenix.py:255-350, :406-482)
run through the port alone.

Tolerances:

- logits: f32 rtol 1e-5, atol 1e-6; bf16 atol 6e-2, as
  tests/test_torch_phoenix.py states them for one request.
- f32 gradients of every parameter against ``jax.grad``: each entry within
  1e-4 of its parameter's largest |entry| (f32 sums in another order,
  through two attention softmaxes; the MaskNet gradient tests' bound) plus
  1e-7 of the largest |entry| of any gradient: under an all-invalid history
  every query attends uniformly, and the cross attention's query and key
  gradients are differences of equal-weight terms, ~100× smaller than the
  terms, so they carry their terms' f32 noise (one rounding, 2^-24 ≈ 6e-8,
  of the gradients' common size; ~2e-9 seen against a 5e-9 floor).
- bf16 gradients. Both sides round every product, activation and residual
  to bf16 (u = 2^-8), and XLA's CPU backend rounds otherwise than torch's,
  so neither is the f32 gradient; JAX also sums a table's repeated ids in
  bf16 (flax's ``nn.Embed(dtype=bf16)`` forms the cotangent of the cast
  table), where the port sums in f32 (the decision in
  models/phoenix.py). The bound: for each parameter, the port's distance
  from the f32 gradient of the same params, ‖g_port − g32‖₂, is at most
  twice JAX's own, ‖g_jax − g32‖₂, plus one bf16 rounding of the gradient,
  2^-8·‖g32‖₂ (a parameter both sides get nearly exact). By the triangle
  inequality the port is then within 3‖g_jax − g32‖₂ + 2^-8‖g32‖₂ of JAX.
  ``author_emb``'s f32 sums are also held to float64 sums of the same
  cotangent rows: m·2^-24·Σ|x| for a row of m slots (any order of f32
  summation).
- 3 adam steps of the port's ``Trainer`` against the JAX ``Trainer``: no
  entry off by more than 2·steps·lr, at most 0.1% beyond 1e-5 (the Adam
  rule of tests/test_torch_mesh_training.py: adam moves an entry by ±lr on
  the sign of a gradient that may be f32 noise).
- the AUC recipe and the round trip: the JAX tests' own bars (AUC > 0.75;
  last loss < 0.7 × first; engaged candidates' mean fav probability above
  the unengaged ones').
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread)
from jax.sharding import PartitionSpec as JP

from the_algorithm_tpu.core import mesh as jmesh
from the_algorithm_tpu.models import phoenix as jp
from the_algorithm_tpu.training.trainer import Trainer as JaxTrainer
from the_algorithm_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from the_algorithm_tpu_torch.mixers import phoenix_loop as pl
from the_algorithm_tpu_torch.models import phoenix
from the_algorithm_tpu_torch.ops import gather
from the_algorithm_tpu_torch.ops.gather import table_read
from the_algorithm_tpu_torch.pipeline.component import Candidate
from the_algorithm_tpu_torch.training import metrics
from the_algorithm_tpu_torch.training.trainer import Trainer, TrainerConfig

B, L, C = 4, 16, 12
SMALL = dict(d_model=32, n_layers=2, n_heads=4, max_history=L, author_buckets=64)
A = phoenix.NUM_ACTIONS
FAV = int(phoenix.ActionName.SERVER_TWEET_FAV)
RTOL, ATOL = 1e-5, 1e-6
BF16_ATOL = 6e-2
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-7
BF16_ROUND = 2.0 ** -8
ADAM_ATOL, ADAM_SHARE = 1e-5, 1e-3
STEPS, LR = 3, 1e-2
HISTORIES = ("full", "all_invalid", "mostly_padding", "full")


# -- inputs --------------------------------------------------------------------


def _user(kind, rng, authors=SMALL["author_buckets"]):
    """One request's history and candidates (numpy): ``kind`` full, mostly
    padding (3 valid) or all invalid; author hashes drawn from a few values
    (ids repeat within and across requests) on both signs and past the
    bucket count; 3 invalid candidates."""
    n_valid = {"full": L, "mostly_padding": 3, "all_invalid": 0}[kind]
    valid = np.zeros(L, bool)
    valid[L - n_valid:] = True
    pool = rng.integers(-2 * authors, 2 * authors, 6)
    seq = dict(action_ids=np.where(valid, rng.integers(1, A, L), 0).astype(np.int32),
               author_hashes=np.where(valid, rng.choice(pool, L), 0).astype(np.int32),
               age_s=np.where(valid, rng.integers(0, 10 ** 6, L), 0).astype(np.int32), valid=valid)
    cvalid = np.ones(C, bool)
    cvalid[-3:] = False
    cands = dict(author_hashes=rng.choice(pool, C).astype(np.int32),
                 bool_features=(rng.random((C, phoenix.NUM_BOOL_FEATURES)) < 0.5).astype(np.float32),
                 valid=cvalid)
    labels = (rng.random((C, A)) < 0.2).astype(np.float32)
    return seq, cands, labels


def _batch(histories, seed):
    """A stacked batch (numpy), one request a history kind."""
    rng = np.random.default_rng(seed)
    users = [_user(k, rng) for k in histories]
    stack = lambda part: {k: np.stack([u[part][k] for u in users]) for k in users[0][part]}  # noqa: E731
    return stack(0), stack(1), np.stack([u[2] for u in users])


def stack_examples(examples):
    """``training_batch``'s per-request (sequence, candidates, labels)
    stacked into one [B, ...] batch: the port's counterpart of the JAX
    tests' ``jax.tree_util.tree_map(jnp.stack, ...)``."""
    seqs, cands, labels = zip(*examples)
    return (phoenix.UserActionSequence(*(torch.stack(f) for f in zip(*seqs))),
            phoenix.CandidateFeatures(*(torch.stack(f) for f in zip(*cands))), torch.stack(labels))


def _port_inputs(seq, cands):
    return (phoenix.UserActionSequence(**{k: torch.from_numpy(v) for k, v in seq.items()}),
            phoenix.CandidateFeatures(**{k: torch.from_numpy(v) for k, v in cands.items()}))


def _jax_inputs(seq, cands):
    return (jp.UserActionSequence(**{k: jnp.asarray(v) for k, v in seq.items()}),
            jp.CandidateFeatures(**{k: jnp.asarray(v) for k, v in cands.items()}))


# -- models --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _flax(dtype):
    """(flax model, the params JAX's ``init`` draws) at SMALL width."""
    jm = jp.PhoenixModel(jp.PhoenixConfig(**SMALL, dtype=dtype))
    seq, cands, _ = _batch(("full",), 0)
    one = lambda d: {k: v[0] for k, v in d.items()}  # noqa: E731
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *_jax_inputs(one(seq), one(cands)))
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port(dtype, params):
    m = phoenix.PhoenixModel(phoenix.PhoenixConfig(**SMALL, dtype=dtype), device="cpu")
    m.load_state_dict(phoenix.params_from_flax(params))
    return m


def _jax_loss(jm):
    """The JAX tests' vmapped apply, ``multi_action_loss`` over the batch's
    rows flattened (the global mean over valid candidates × actions)."""
    def loss(p, seq, cands, labels):
        logits = jax.vmap(lambda s, c: jm.apply(p, s, c))(seq, cands)
        return jp.multi_action_loss(logits.reshape(-1, A), labels.reshape(-1, A), cands.valid.reshape(-1))
    return loss


def _port_loss(model, batch):
    seq, cands, labels = batch
    return phoenix.multi_action_loss(model(seq, cands), labels, cands.valid), {}


def _jax_grads(dtype, params, batch):
    jm, _ = _flax(dtype)
    seq, cands, labels = batch
    g = jax.jit(jax.grad(_jax_loss(jm)))(params, *_jax_inputs(seq, cands), jnp.asarray(labels))
    return phoenix.params_from_flax(jax.tree_util.tree_map(np.asarray, g))


def _port_grads(model, batch):
    seq, cands, labels = batch
    model.zero_grad(set_to_none=True)
    loss, _ = _port_loss(model, (*_port_inputs(seq, cands), torch.from_numpy(labels)))
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


# -- the forward -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_forward_matches_vmapped_flax(dtype):
    """[B, L], [B, C] → [B, C, A] against ``jax.vmap(model.apply)``: each
    request's own masks (full, all-invalid and mostly padded histories in
    one batch)."""
    jm, params = _flax(dtype)
    seq, cands, _ = _batch(HISTORIES, 1)
    want = np.asarray(jax.jit(jax.vmap(lambda s, c: jm.apply(params, s, c)))(*_jax_inputs(seq, cands)))
    with torch.inference_mode():
        got = _port(dtype, params)(*_port_inputs(seq, cands)).numpy()
    assert got.shape == (B, C, A) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def _key_mask_before(valid):
    zero = torch.zeros((), dtype=torch.float32)
    return torch.where(valid[None, None, :], zero, zero + phoenix.MASK_NEG)


def _attend_before(q, k, v, mask, dtype):
    logits = torch.einsum("qhd,khd->hqk", q, k).float()
    logits = logits / np.float32(np.sqrt(q.shape[-1])) + mask
    return torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1).to(dtype), v)


def _block_before(b, x, valid):
    Lx, D = x.shape
    H, dt = b.n_heads, b.dtype
    qkv = b.qkv(b.LayerNorm_0(x).to(dt)).reshape(Lx, 3 * H, D // H)
    mask = _key_mask_before(valid)
    causal = torch.tril(torch.ones((Lx, Lx), dtype=torch.bool))
    zero = torch.zeros((), dtype=torch.float32)
    mask = mask + torch.where(causal[None], zero, zero + phoenix.MASK_NEG)
    x = x + b.proj(_attend_before(qkv[:, :H], qkv[:, H:2 * H], qkv[:, 2 * H:], mask, dt).reshape(Lx, D))
    h = torch.nn.functional.gelu(b.mlp_up(b.LayerNorm_1(x).to(dt)), approximate="tanh")
    return x + b.mlp_down(h)


def _forward_before(m, seq, cands):
    """The single-request forward as the port computed it before the forward
    took a batch (a frozen copy over ``m``'s modules)."""
    cfg = m.config
    dt, D, H = cfg.compute_dtype, cfg.d_model, cfg.n_heads
    hashes = torch.cat([seq.author_hashes, cands.author_hashes]).to(torch.int32)
    auth = table_read(m.author_emb.embedding, torch.remainder(hashes, cfg.author_buckets)).to(dt)
    auth_hist, auth_cand = auth[:L], auth[L:]
    age = torch.searchsorted(m.age_bounds, seq.age_s.to(torch.int32).contiguous(), right=False)
    x = (m.action_emb.embedding[seq.action_ids.long()].to(dt) + auth_hist + m.age_emb.embedding[age].to(dt)
         + m.pos_emb.to(dt))
    for i in range(cfg.n_layers):
        x = _block_before(getattr(m, f"enc_{i}"), x, seq.valid)
    x = m.enc_ln(x).to(dt)
    cq = m.cand_ln(auth_cand + m.bool_proj(cands.bool_features.to(dt))).to(dt)
    q = m.xq(cq).reshape(-1, H, D // H)
    k, v = m.xk(x).reshape(-1, H, D // H), m.xv(x).reshape(-1, H, D // H)
    r = _attend_before(q, k, v, _key_mask_before(seq.valid), dt).reshape(-1, D) + cq
    h = torch.nn.functional.gelu(m.head_mlp(m.head_ln(r).to(dt)), approximate="tanh")
    return m.action_head(h.float())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unbatched_forward_keeps_its_bits(dtype):
    """The one-request call serving makes (``scorer_predict_fn``) gives the
    bits the forward gave before it took a batch, and each request of a
    batch gives its own unbatched bits; logits and every gradient."""
    _, params = _flax(dtype)
    m = _port(dtype, params)
    seq, cands, _ = _batch(HISTORIES, 2)
    seq_t, cands_t = _port_inputs(seq, cands)
    with torch.inference_mode():
        batched = m(seq_t, cands_t)
    for b in range(B):
        s = phoenix.UserActionSequence(*(t[b] for t in seq_t))
        c = phoenix.CandidateFeatures(*(t[b] for t in cands_t))
        got = m(s, c)
        want = _forward_before(m, s, c)
        assert torch.equal(got, want) and torch.equal(got.detach(), batched[b])
        got.sum().backward()
        g1 = {n: p.grad.clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        want.sum().backward()
        assert all(torch.equal(g1[n], p.grad) for n, p in m.named_parameters())
        m.zero_grad(set_to_none=True)


# -- gradients -------------------------------------------------------------------


@pytest.mark.parametrize("histories", [HISTORIES, ("all_invalid",) * 3], ids=["mixed", "all_invalid"])
def test_f32_gradients_match_jax_grad(histories):
    """Every parameter's f32 gradient of ``multi_action_loss`` over a batch
    against ``jax.grad`` of the vmapped loss: author ids repeated within and
    across requests (``run_collapse_rows``' runs), full, mostly padded and
    all-invalid histories (uniform attention over -1e9 masks: finite and
    equal)."""
    _, params = _flax("float32")
    batch = _batch(histories, 3)
    want = _jax_grads("float32", params, batch)
    got = _port_grads(_port("float32", params), batch)
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for n, g in got.items():
        w = want[n].numpy()
        assert np.isfinite(g.numpy()).all(), n
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * np.abs(w).max() + floor, err_msg=n)
    assert np.abs(want["author_emb.embedding"].numpy()).max() > 0


def test_bf16_gradients_within_the_derived_bound():
    """bf16 gradients of every parameter: the port's distance from the f32
    gradient of the same params at most twice JAX's bf16 distance plus one
    bf16 rounding (the module's bound), hence within 3× JAX's distance of
    JAX's own; ``author_emb``'s f32 sums within m·2^-24·Σ|x| of float64 sums
    of the cotangent rows that reach ``run_collapse_rows``."""
    _, params = _flax("bfloat16")
    batch = _batch(HISTORIES, 4)
    g32 = _jax_grads("float32", params, batch)
    jax16 = _jax_grads("bfloat16", params, batch)
    seen, inner = [], gather.run_collapse_rows

    def recording(ids, perm, dy, num_rows):
        seen.append((ids, perm, dy.clone(), num_rows))
        return inner(ids, perm, dy, num_rows)

    gather.run_collapse_rows = recording
    try:
        port16 = _port_grads(_port("bfloat16", params), batch)
    finally:
        gather.run_collapse_rows = inner
    for n in g32:
        ref = g32[n].double()
        e_jax = float((jax16[n].double() - ref).norm())
        e_port = float((port16[n].double() - ref).norm())
        bound = 2 * e_jax + BF16_ROUND * float(ref.norm())
        assert e_port <= bound, (n, e_port, e_jax)
        assert float((port16[n].double() - jax16[n].double()).norm()) <= e_jax + bound, n
    (ids, perm, dy, n_rows), = seen
    keep = (ids >= 0) & (ids < n_rows)
    rows = torch.where(keep, ids, n_rows).long()
    x = dy[perm].double()
    sums = torch.zeros((n_rows + 1, dy.shape[1]), dtype=torch.float64).index_add_(0, rows, x)[:n_rows]
    mags = torch.zeros((n_rows + 1, dy.shape[1]), dtype=torch.float64).index_add_(0, rows, x.abs())[:n_rows]
    terms = torch.bincount(rows, minlength=n_rows + 1)[:n_rows, None].double()
    got = port16["author_emb.embedding"].double()
    assert bool(((got - sums).abs() <= terms * 2.0 ** -24 * mags).all())
    assert int(terms.max()) > 1  # repeated ids: runs of more than one slot
    assert ids.numel() == B * (L + C)  # one read of every request's history and candidates


# -- training ----------------------------------------------------------------------


def test_trainer_steps_follow_the_jax_trainer():
    """Three adam steps (``TrainerConfig(optimizer="adam")``: optax.adamw at
    decay 0, optax.adam's update) of the port's one-device ``Trainer`` over
    the batched loss, against the JAX ``Trainer`` running the same vmapped
    loss from the same flax params on a one-device mesh: each step's loss
    (rtol 1e-5) and every parameter after the steps (the Adam rule)."""
    jm, params = _flax("float32")
    batches = [_batch(HISTORIES, 10 + i) for i in range(STEPS)]
    loss = _jax_loss(jm)
    mesh = jmesh.make_mesh(jmesh.MeshSpec(data=1, model=1), jax.devices()[:1])
    with jmesh.local_mesh(mesh):
        jt = JaxTrainer(lambda p, b: (loss(p, *b), {}), jax.tree_util.tree_map(np.array, params), mesh,
                        [(".*", JP())], JaxTrainerConfig(learning_rate=LR, optimizer="adam"))
        want_losses = [float(jt.train_step((*_jax_inputs(s, c), jnp.asarray(y)))["loss"]) for s, c, y in batches]
    want = phoenix.params_from_flax(jax.tree_util.tree_map(np.asarray, jt.params))
    tr = Trainer(_port_loss, _port("float32", params), TrainerConfig(learning_rate=LR, optimizer="adam"),
                 device="cpu")
    losses = [float(tr.train_step((*_port_inputs(s, c), torch.from_numpy(y)))["loss"]) for s, c, y in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    total = beyond = 0
    for n, p in tr.model.named_parameters():
        diff = (p.detach().double() - want[n].double()).abs()
        assert float(diff.max()) <= 2 * STEPS * LR, n
        total += diff.numel()
        beyond += int((diff > ADAM_ATOL).sum())
    assert beyond <= ADAM_SHARE * total, (beyond, total)


def _sample(rng, batch, cfg):
    """The JAX recipe's draw (tests/test_phoenix.py:271-302): each user's
    history repeats engagements with 4 liked authors; a candidate is a fav
    iff its author is liked. Returns a stacked batch."""
    Lr, Cr, nb = cfg.max_history, 8, cfg.author_buckets
    seqs, cands, labels = [], [], []
    for _ in range(batch):
        liked = rng.choice(nb, 4, replace=False)
        seqs.append(phoenix.UserActionSequence(
            torch.full((Lr,), FAV, dtype=torch.int32), torch.from_numpy(rng.choice(liked, Lr).astype(np.int32)),
            torch.from_numpy((np.arange(Lr)[::-1] * 60).astype(np.int32)), torch.ones(Lr, dtype=torch.bool)))
        c_auth = rng.choice(nb, Cr)
        cands.append(phoenix.CandidateFeatures(torch.from_numpy(c_auth.astype(np.int32)),
                                               torch.zeros((Cr, phoenix.NUM_BOOL_FEATURES)),
                                               torch.ones(Cr, dtype=torch.bool)))
        lab = np.zeros((Cr, A), np.float32)
        lab[:, FAV] = np.isin(c_auth, liked)
        labels.append(torch.from_numpy(lab))
    return stack_examples(list(zip(seqs, cands, labels)))


def fav_weighted_loss(model, batch):
    """The JAX recipe's loss: positive-weighted BCE on the fav head
    (tests/test_phoenix.py:321-330)."""
    seq, cands, labels = batch
    lg, y = model(seq, cands)[..., FAV], labels[..., FAV]
    ce = torch.clamp(lg, min=0) - lg * y + torch.log1p(torch.exp(-lg.abs()))
    return torch.mean(ce * torch.where(y > 0, 3.0, 1.0)), {}


def test_auc_recipe_through_the_port():
    """The JAX recipe at its own shape (d 32, 1 layer, 2 heads, L 16, 32
    buckets, f32; 300 steps of 32 users, adam 1e-3) through the port's
    ``Trainer`` from the port's own init: held-out AUC of the fav head on
    64 users above 0.75."""
    cfg = phoenix.PhoenixConfig(d_model=32, n_layers=1, n_heads=2, max_history=16, author_buckets=32,
                                dtype="float32")
    rng = np.random.default_rng(0)
    model = phoenix.PhoenixModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tr = Trainer(fav_weighted_loss, model, TrainerConfig(learning_rate=1e-3, optimizer="adam"), device="cpu")
    for _ in range(300):
        tr.train_step(_sample(rng, 32, cfg))
    seq, cands, labels = _sample(rng, 64, cfg)
    with torch.no_grad():
        probs = torch.sigmoid(model(seq, cands)[..., FAV])
    auc = float(metrics.auc(probs.reshape(-1), labels[..., FAV].reshape(-1)))
    assert auc > 0.75, auc


class _Query:
    def __init__(self, uid, now):
        self.user_id, self.now, self.features = uid, now, {}


def test_serve_log_retrain_round_trip_through_the_port():
    """The JAX round trip (tests/test_phoenix.py:406-482) through the port:
    6 served requests of 8 candidates logged by the side effect, even tweet
    ids faved, ``training_batch`` at max_candidates 8 with all-invalid
    histories, a d 16 model trained request by request (adam 1e-2, 60
    epochs) through the ``Trainer``: last loss below 0.7 × the first, and
    the engaged candidates' mean fav probability above the unengaged ones'."""
    rng = np.random.default_rng(0)
    Lr, Cr = 8, 8
    se = pl.ScoredPhoenixCandidatesSideEffect(pl.PhoenixScoreStore())
    for uid in range(6):
        se.run(_Query(uid, 100 + uid), [Candidate(id=1000 * uid + i, score=0.5,
                                                  features={"author_id": (uid + i) % 16,
                                                            "phoenix_fav": float(rng.random())})
                                        for i in range(Cr)], None)
    assert len(se.log) == 6 * Cr
    engagements = {(r.user_id, r.tweet_id): [FAV] for r in se.log if r.tweet_id % 2 == 0}

    def seq_for(uid):
        return phoenix.UserActionSequence(torch.zeros(Lr, dtype=torch.int32), torch.zeros(Lr, dtype=torch.int32),
                                          torch.zeros(Lr, dtype=torch.int32), torch.zeros(Lr, dtype=torch.bool))

    batches = pl.training_batch(se.log, engagements, seq_for, author_buckets=64, max_candidates=Cr)
    assert len(batches) == 6
    cfg = phoenix.PhoenixConfig(d_model=16, n_layers=1, n_heads=2, max_history=Lr, author_buckets=64)
    model = phoenix.PhoenixModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tr = Trainer(_port_loss, model, TrainerConfig(learning_rate=1e-2, optimizer="adam"), device="cpu")
    losses = [float(tr.train_step(b)["loss"]) for _ in range(60) for b in batches]
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])
    seq0, cands0, _ = batches[0]
    with torch.no_grad():
        fav = phoenix.predict_next_actions(model, seq0, cands0)[:, FAV].numpy()
    recs = sorted(se.log[:Cr], key=lambda r: r.position)
    even = [i for i, r in enumerate(recs) if r.tweet_id % 2 == 0]
    odd = [i for i, r in enumerate(recs) if r.tweet_id % 2 == 1]
    assert fav[even].mean() > fav[odd].mean()
    # the same log stacked into one [6, ...] batch: its rows are the requests'
    seq, cands, labels = stack_examples(batches)
    assert seq.action_ids.shape == (6, Lr) and cands.bool_features.shape == (6, Cr, phoenix.NUM_BOOL_FEATURES)
    with torch.no_grad():
        np.testing.assert_array_equal(model(seq, cands)[0].numpy(), model(seq0, cands0).numpy())

"""The port's trust & safety classifiers and their recipe
(the_algorithm_tpu_torch/models/{trust_safety, trust_safety_train}.py)
against the JAX package's.

Tolerances:

- ``TextSafetyModel`` (vocab 512, L 16, dim 32, heads 4, layers 2) and
  ``MediaSafetyModel`` on even and odd image sizes from flax's ``init``
  through ``params_from_flax``, an all-pad text included: rtol 1e-5 /
  atol 1e-6 (f32 sums in another order);
- the embedding's gradient (the D-wide collapse's plain version) against
  ``jax.grad``: rtol 1e-5 / atol 1e-6;
- ``tokenize_text``, ``class_pos_weights``, ``weighted_bce``'s value at
  rtol 1e-6, ``kfold_indices`` exactly; ``make_schedule`` at every step
  against optax at rtol 1e-5 / atol 1e-6 of the peak rate (numpy's and
  XLA's f32 ``cos`` differ by an ulp or so, and 1 + cos cancels near the
  end of the decay);
- a 2-fold, 1-epoch ``train_kfold`` from JAX's per-fold init: every
  parameter within the Adam rule of JAX's (each step moves a parameter by
  at most about lr, so |Δ| ≤ 2·steps·lr, and no more than 0.1% of the
  entries more than 1e-5 apart), AUCs within 0.02. The attention key biases
  count in the first bound only: their exact gradient is zero (a softmax
  does not change when every logit of a query moves by q·b), so both
  packages' Adam steps normalise rounding noise of ~1e-9 to steps of ~lr.
"""

import functools

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread)

from the_algorithm_tpu.models import trust_safety as jts
from the_algorithm_tpu.models import trust_safety_train as jtst
from the_algorithm_tpu_torch.models import trust_safety as ts
from the_algorithm_tpu_torch.models import trust_safety_train as tst

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(vocab_size=512, max_len=16, dim=32, heads=4, layers=2)
TEXTS = ["you are horrible", "", "a perfectly nice day #sunny @friend", "ＦＵＬＬ width ＴＥＸＴ 123",
         "repeated repeated repeated words words", "日本語のテキスト", "http://t.co/x $AAPL"]


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _text_batch(cfg, jcfg):
    toks, masks = zip(*(ts.tokenize_text(t, cfg) for t in TEXTS))
    for t, (a, b) in zip(TEXTS, zip(toks, masks)):
        ja, jb = jts.tokenize_text(t, jcfg)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    rng = np.random.default_rng(0)
    tok = np.concatenate([np.stack([t.numpy() for t in toks]), rng.integers(0, 512, (5, 16)).astype(np.int32)])
    mask = np.concatenate([np.stack([m.numpy() for m in masks]), (rng.random((5, 16)) < 0.7).astype(np.float32)])
    mask[-1] = 0.0  # an all-pad row with tokens under it
    return tok, mask


@functools.lru_cache(maxsize=None)
def _flax_text():
    cfg, jcfg = ts.TextEncoderConfig(**SMALL), jts.TextEncoderConfig(**SMALL)
    jm = jts.TextSafetyModel(jcfg)
    tok, mask = _text_batch(cfg, jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(tok), jnp.asarray(mask))
    return jm, variables, tok, mask


def _text_models():
    jm, variables, tok, mask = _flax_text()
    m = ts.params_from_flax(ts.TextSafetyModel(ts.TextEncoderConfig(**SMALL), device="cpu"), variables)
    return jm, m, variables, tok, mask


def test_text_model_matches_flax():
    jm, m, variables, tok, mask = _text_models()
    want = jax.jit(jm.apply)(variables, jnp.asarray(tok), jnp.asarray(mask))
    got = m(torch.from_numpy(tok), torch.from_numpy(mask)).detach()
    assert got.shape == (len(tok), 3) and torch.isfinite(got).all()
    _close(got, want)
    assert ts.TextSafetyModel(ts.TextEncoderConfig(**SMALL), device="cpu").heads == jm.heads


def test_text_embedding_gradient_matches_jax():
    jm, m, variables, tok, mask = _text_models()
    y = (np.arange(len(tok))[:, None] % 2 == np.arange(3)[None] % 2).astype(np.float32)
    pw, sw = np.asarray([1.0, 2.0, 3.0], np.float32), np.linspace(0.5, 1.5, len(tok)).astype(np.float32)

    def jloss(v):
        return jtst.weighted_bce(jm.apply(v, jnp.asarray(tok), jnp.asarray(mask)), jnp.asarray(y),
                                 jnp.asarray(pw), jnp.asarray(sw))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables)
    loss = tst.weighted_bce(m(torch.from_numpy(tok), torch.from_numpy(mask)), torch.from_numpy(y),
                            torch.from_numpy(pw), torch.from_numpy(sw))
    loss.backward()
    _close(loss.item(), jl, rtol=1e-6)
    genc = jg["params"]["encoder"]
    _close(m.encoder.token_emb.grad, genc["token_emb"]["embedding"])
    _close(m.encoder.pos_emb.grad, genc["pos_emb"])
    _close(m.encoder.blocks[1].attn.query_kernel.grad, genc["block_1"]["attn"]["query"]["kernel"])
    _close(m.cls.kernel.grad, jg["params"]["cls"]["kernel"])


@pytest.mark.parametrize("hw", [(32, 32), (33, 29)])
def test_media_model_matches_flax(hw):
    jm = jts.MediaSafetyModel(widths=(4, 8, 8))
    x = np.random.default_rng(hw[0]).normal(size=(2,) + hw + (3,)).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    m = ts.params_from_flax(ts.MediaSafetyModel(widths=(4, 8, 8), device="cpu"), variables)
    got = m(torch.from_numpy(x)).detach()
    assert got.shape == (2, 1)
    _close(got, jax.jit(jm.apply)(variables, jnp.asarray(x)))
    assert [ts.same_pads(n, 3, 2) for n in (224, 225, 4, 5)] == [(0, 1), (1, 1), (0, 1), (1, 1)]


def test_schedules_match_optax():
    for name in ("cosine", "warmup_linear", "constant"):
        for total, warm in ((100, 0.1), (7, 0.3)):
            cfg = tst.RecipeConfig(schedule=name, learning_rate=3e-3, warmup_frac=warm)
            jcfg = jtst.RecipeConfig(schedule=name, learning_rate=3e-3, warmup_frac=warm)
            got, want = tst.make_schedule(cfg, total), jtst.make_schedule(jcfg, total)
            steps = np.arange(total + 3, dtype=np.int32)
            g = np.asarray([got(int(s)) for s in steps], np.float32)
            jwant = jax.jit(want)
            w = np.asarray([jwant(jnp.int32(s)) for s in steps], np.float32)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * cfg.learning_rate, err_msg=f"{name} {total}")
            assert (g[0] == 0.0) == (name != "constant")
    with pytest.raises(ValueError):
        tst.make_schedule(tst.RecipeConfig(schedule="nope"), 10)


def test_weights_loss_and_folds_match_jax():
    rng = np.random.default_rng(2)
    labels = (rng.random((100, 3)) < [0.1, 0.5, 0.0]).astype(np.float32)
    np.testing.assert_array_equal(tst.class_pos_weights(labels), jtst.class_pos_weights(labels))
    logits = rng.normal(size=(100, 3)).astype(np.float32) * 5
    pw, sw = tst.class_pos_weights(labels), rng.random(100).astype(np.float32)
    got = tst.weighted_bce(*(torch.from_numpy(a) for a in (logits, labels, pw, sw)))
    _close(got.item(), jtst.weighted_bce(*(jnp.asarray(a) for a in (logits, labels, pw, sw))), rtol=1e-6)
    for n, folds, seed, strat in ((100, 5, 0, None), (200, 4, 1, (np.arange(200) < 40)), (37, 3, 5, labels[:37, 0])):
        for (a, b), (c, d) in zip(tst.kfold_indices(n, folds, seed, strat), jtst.kfold_indices(n, folds, seed, strat)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def _pool(n=192, L=16, vocab=512, seed=0):
    """tests/test_trust_safety_train.py's separable pool at the small config."""
    rng = np.random.default_rng(seed)
    y_tox = (rng.random(n) < 0.3).astype(np.float32)
    tokens = rng.integers(0, vocab // 2, (n, L)).astype(np.int32)
    band = rng.integers(vocab // 2, vocab, (n, L)).astype(np.int32)
    tokens = np.where((y_tox[:, None] > 0) & (rng.random((n, L)) < 0.6), band, tokens)
    mask = np.ones((n, L), np.float32)
    mask[::11, 8:] = 0.0
    y_nsfw = np.clip(y_tox + (rng.random(n) < 0.05), 0, 1).astype(np.float32)
    y_abuse = y_tox * (rng.random(n) < 0.8).astype(np.float32)
    return tokens, mask, np.stack([y_tox, y_nsfw, y_abuse], axis=1)


def test_train_kfold_matches_jax():
    tokens, mask, labels = _pool()
    kw = dict(folds=2, epochs=1, batch_size=32, learning_rate=3e-3)
    jm = jts.TextSafetyModel(jts.TextEncoderConfig(**SMALL))
    want = jtst.train_kfold(jm, tokens, mask, labels, jtst.RecipeConfig(**kw))
    template = ts.TextSafetyModel(ts.TextEncoderConfig(**SMALL), device="cpu")

    def jax_init(fold):  # the JAX recipe's per-fold draw (trust_safety_train.py:175-177)
        v = jm.init(jax.random.PRNGKey(fold), jnp.asarray(tokens[:1]), jnp.asarray(mask[:1]))
        return ts.params_from_flax(copy.deepcopy(template), v).state_dict()

    got = tst.train_kfold(template, tokens, mask, labels, tst.RecipeConfig(**kw), init_params=jax_init)
    assert len(got.folds) == 2 and got.head_names == want.head_names
    steps = (len(tokens) // 2) // 32
    bound = 2 * steps * kw["learning_rate"]
    for gf, wf in zip(got.folds, want.folds):
        jstate = ts.params_from_flax(copy.deepcopy(template), wf.params).state_dict()
        far = n = 0
        for k, v in gf.params.items():
            d = np.abs(v.numpy() - jstate[k].numpy())
            assert d.max() <= bound, (k, d.max())
            if not k.endswith("attn.key_bias"):
                far, n = far + int((d > 1e-5).sum()), n + d.size
        assert far <= 1e-3 * n, (far, n)
        np.testing.assert_allclose(gf.auc_per_head, wf.auc_per_head, atol=0.02)
    np.testing.assert_allclose(got.oof_auc_per_head, want.oof_auc_per_head, atol=0.02)
    np.testing.assert_allclose(got.mean_auc, want.mean_auc, atol=0.02)

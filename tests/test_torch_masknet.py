"""Port MaskNet (the_algorithm_tpu_torch/models/masknet.py) against the JAX
package's flax module on the same weights: flax init → numpy →
``params_from_flax`` → the same logits within atol 1e-5 in the f32 config
(f32 products summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from the_algorithm_tpu.models import masknet as jax_masknet
from the_algorithm_tpu_torch.models import masknet

SMALL = dict(num_features=64, num_heads=4, mask_blocks=2, block_dim=16,
             aggregation_dim=8, head_hidden=(16,), dtype="float32")


@pytest.fixture(scope="module")
def flax_model():
    cfg = jax_masknet.MaskNetConfig(**SMALL)
    model = jax_masknet.MaskNet(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.num_features)))
    # flax inits LayerNorm scales to 1 and biases to 0; perturb them so the
    # test sees the (G, D) affine and the input-LN affine really applied
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params
    )
    return model, params


def _features(B=5, F=64, seed=1):
    # small-variance rows (var ≈ 1e-3), so that torch's default LayerNorm
    # eps of 1e-5 in place of flax's 1e-6 would move the logits by ~0.5%;
    # zero-mean, because flax computes the variance as E[x²] - E[x]²
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, F)) * 0.03).astype(np.float32)


def test_logits_match_flax_on_the_same_weights(flax_model):
    model, params = flax_model
    x = _features()
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    port = masknet.MaskNet(masknet.MaskNetConfig(**SMALL), device="cpu")
    port.load_state_dict(masknet.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (5, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_state_dict_has_exactly_the_flax_params(flax_model):
    _, params = flax_model
    port = masknet.MaskNet(masknet.MaskNetConfig(**SMALL), device="cpu")
    sd = masknet.params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].shape == v.shape, k
    # a flax Dense kernel is [in, out]; the torch weight is [out, in]
    np.testing.assert_array_equal(
        sd["mask_agg.weight"].numpy(), np.asarray(params["params"]["mask_agg"]["kernel"]).T
    )


def test_bf16_config_tracks_f32_on_the_same_weights():
    cfg32 = masknet.MaskNetConfig(**SMALL)
    cfg16 = masknet.MaskNetConfig(**{**SMALL, "dtype": "bfloat16"})
    m32 = masknet.MaskNet(cfg32, device="cpu", generator=torch.Generator().manual_seed(3))
    m16 = masknet.MaskNet(cfg16, device="cpu")
    m16.load_state_dict(m32.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 64)).astype(np.float32))
    with torch.no_grad():
        a, b = m32(x), m16(x)
    assert b.dtype == torch.float32  # the heads run in f32
    torch.testing.assert_close(b, a, atol=0.1, rtol=0.05)


def test_default_device_is_the_card_and_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        masknet.MaskNet(masknet.MaskNetConfig(**SMALL))
    with pytest.raises(RuntimeError, match="GPU"):
        masknet.GroupLayerNorm(2, 16, torch.float32)
    with pytest.raises(RuntimeError, match="GPU"):
        masknet.MaskNet(masknet.MaskNetConfig(**SMALL), device="cuda")
    built = masknet.MaskNet(masknet.MaskNetConfig(**SMALL), device="cpu")
    assert {p.device.type for p in built.parameters()} == {"cpu"}


def test_init_is_reproducible_from_the_generator():
    cfg = masknet.MaskNetConfig(**SMALL)
    a = masknet.MaskNet(cfg, device="cpu", generator=torch.Generator().manual_seed(7)).state_dict()
    b = masknet.MaskNet(cfg, device="cpu", generator=torch.Generator().manual_seed(7)).state_dict()
    c = masknet.MaskNet(cfg, device="cpu", generator=torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["hidden.weight"], c["hidden.weight"])
    # lecun-normal scale: std ≈ 1/sqrt(fan_in)
    assert abs(float(a["hidden.weight"].std()) * np.sqrt(64) - 1.0) < 0.1


@pytest.mark.parametrize(
    "weights",
    [
        np.asarray(jax_masknet.DEFAULT_HEAD_WEIGHTS),  # mixed signs
        np.array([1.0, 2.0, 0.5], np.float32),  # all positive
        np.zeros(3, np.float32),  # total == 0 branch
    ],
    ids=["default", "positive", "zero"],
)
def test_weighted_model_score_matches_jax(weights):
    rng = np.random.default_rng(4)
    probs = rng.random((64, weights.shape[0])).astype(np.float32)
    probs[:8] = 0.0
    probs[8:16, -2:] = 1.0  # the negative heads dominate: combined < 0
    got = masknet.weighted_model_score(torch.from_numpy(probs), torch.tensor(weights))
    want = jax_masknet.weighted_model_score(jnp.asarray(probs), jnp.asarray(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)


def test_default_head_table_matches_jax():
    assert tuple(masknet.DEFAULT_HEAD_NAMES) == tuple(jax_masknet.DEFAULT_HEAD_NAMES)
    np.testing.assert_array_equal(
        masknet.DEFAULT_HEAD_WEIGHTS.numpy(), np.asarray(jax_masknet.DEFAULT_HEAD_WEIGHTS)
    )

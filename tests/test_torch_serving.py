"""The port's serving edge (the_algorithm_tpu_torch/serving/) on the CPU:
dynamic batcher, npz model registry with version hot-swap, and the HTTP
predict front serving a small port MaskNet."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from the_algorithm_tpu_torch.models import masknet
from the_algorithm_tpu_torch.serving.batcher import BatcherConfig, DynamicBatcher, RequestBatcher
from the_algorithm_tpu_torch.serving.model_registry import (
    ModelRegistry,
    load_params_npz,
    save_params_npz,
)
from the_algorithm_tpu_torch.serving.server import InferenceServer

SMALL = masknet.MaskNetConfig(num_features=12, num_heads=3, mask_blocks=2, block_dim=8,
                              aggregation_dim=4, head_hidden=(8,), dtype="float32")
WEIGHTS = torch.tensor([1.0, 2.0, -3.0])


def _save_version(root, version, seed):
    model = masknet.MaskNet(SMALL, device="cpu", generator=torch.Generator().manual_seed(seed))
    save_params_npz(f"{root}/ranker/{version}", {k: v.numpy() for k, v in model.state_dict().items()})
    return model


def _build(params):
    model = masknet.MaskNet(SMALL, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return masknet.score_fn(model, WEIGHTS)


def _post(port, model, instances):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{model}:predict",
        data=json.dumps({"instances": instances}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def test_batcher_coalesces_and_slices():
    seen = []

    def predict(x):
        seen.append(x.shape[0])
        return x[:, 0] * 2

    b = DynamicBatcher(predict, BatcherConfig(max_batch_size=64, max_delay_ms=30.0))
    try:
        futs = [b.submit(np.full((2, 3), i, np.float32)) for i in range(6)]
        outs = [f.result(timeout=5) for f in futs]
    finally:
        b.close()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, [2 * i, 2 * i])
    assert max(seen) >= 12 and all(n & (n - 1) == 0 for n in seen)  # pow2 padded


def test_request_batcher_propagates_errors():
    def serve(items):
        raise ValueError("boom")

    rb = RequestBatcher(serve, BatcherConfig(max_batch_size=4, max_delay_ms=1.0))
    try:
        with pytest.raises(ValueError):
            rb.serve("x", timeout=5)
    finally:
        rb.close()


def test_registry_swaps_to_the_latest_npz_version(tmp_path):
    root = str(tmp_path)
    save_params_npz(f"{root}/m/1", {"w": np.ones(3)})
    (tmp_path / "m" / "staging").mkdir()
    reg = ModelRegistry(root)
    assert reg.scan_once() == ["m"] and reg.version("m") == 1
    save_params_npz(f"{root}/m/2", {"w": np.full(3, 5.0)})
    assert reg.scan_once() == ["m"] and reg.version("m") == 2
    np.testing.assert_array_equal(load_params_npz(f"{root}/m/2")["w"], 5.0)
    assert reg.scan_once() == []
    with pytest.raises(KeyError):
        reg.get("nope")


def test_server_predicts_with_a_masknet_and_hot_swaps_versions(tmp_path):
    root = str(tmp_path)
    v1 = _save_version(root, 1, seed=0)
    reg = ModelRegistry(root, poll_interval_s=0.05)
    reg.scan_once()
    srv = InferenceServer(reg, _build, batcher_config=BatcherConfig(max_delay_ms=1.0))
    srv.start()
    x = np.random.default_rng(0).standard_normal((5, 12)).astype(np.float32)
    try:
        out = _post(srv.port, "ranker", x.tolist())
        want = masknet.score_fn(v1, WEIGHTS)(x)
        np.testing.assert_allclose(out["predictions"], want, rtol=1e-6)
        assert json.loads(_get(srv.port, "/v1/models")) == {"ranker": {"version": 1}}

        v2 = _save_version(root, 2, seed=1)
        reg.scan_once()
        out2 = _post(srv.port, "ranker", x.tolist())
        np.testing.assert_allclose(out2["predictions"], masknet.score_fn(v2, WEIGHTS)(x), rtol=1e-6)
        assert not np.allclose(out2["predictions"], out["predictions"])
        assert "requests:ranker_total 2" in _get(srv.port, "/metrics")

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "missing", x.tolist())
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "ranker", [])
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:  # wrong width: the model raises
            _post(srv.port, "ranker", [[1.0, 2.0]])
        assert e.value.code == 500
    finally:
        srv.close()

"""The port's mesh (the_algorithm_tpu_torch/core/mesh.py) against the JAX
package's: ``MeshSpec.resolve`` (the same shapes and error texts), the
rank layout (rank r at (r // model, r % model), as JAX lays out
``jax.devices()``), and each collective a shard_map body calls, on 4 gloo
ranks (tests/torch_mesh_ranks.py) held against the JAX mesh's device
coordinates and numpy. Integer collectives are exact; the float sum is of
whole numbers, exact too."""

import jax
import numpy as np
import pytest
from torch_mesh_ranks import run_ranks

from the_algorithm_tpu.core import mesh as jmesh
from the_algorithm_tpu_torch.core import mesh

KEYS = ["1x4", "2x2", "1x2", "1x1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = {"rows": np.arange(40, dtype=np.int32).reshape(10, 4)}
    return inputs, run_ranks("mesh", 4, tmp_path_factory.mktemp("mesh"), inputs)


@pytest.mark.parametrize("spec,n", [((-1, 1), 8), ((-1, 4), 8), ((2, 4), 8), ((-1, 3), 8), ((2, 2), 8),
                                    ((3, -1), 3), ((-1, 0), 5), ((1, 1), 1)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    def resolve(cls):
        try:
            got = cls(data=spec[0], model=spec[1]).resolve(n)
            return got.data, got.model
        except ValueError as e:
            return str(e)

    assert resolve(mesh.MeshSpec) == resolve(jmesh.MeshSpec)


def test_axis_names_match_jax():
    assert (mesh.DATA_AXIS, mesh.MODEL_AXIS) == (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)


@pytest.mark.parametrize("key", KEYS)
def test_rank_layout_matches_jax_device_layout(runs, key):
    _, outs = runs
    d, m = (int(x) for x in key.split("x"))
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=d, model=m), jax.devices()[:d * m])
    for r in range(d * m):
        got = outs[r][key]
        (di,), (mi,) = np.nonzero(jm.devices == jax.devices()[r])
        assert got["coord"] == (di, mi) == (r // m, r % m)
        assert got["shape"] == (jm.shape["data"], jm.shape["model"])
        assert got["model_ranks"] == [di * m + j for j in range(m)]
        assert got["data_ranks"] == [i * m + mi for i in range(d)]
        assert got["global_is_local"]


@pytest.mark.parametrize("key", KEYS)
def test_collectives_over_each_axis(runs, key):
    _, outs = runs
    d, m = (int(x) for x in key.split("x"))
    x = {r: np.arange(6, dtype=np.int32).reshape(2, 3) + 100 * r for r in range(d * m)}
    for r in range(d * m):
        got = outs[r][key]
        row = [x[(r // m) * m + j] for j in range(m)]  # this rank's 'model' group, in coordinate order
        col = [x[i * m + r % m] for i in range(d)]  # its 'data' group
        np.testing.assert_array_equal(got["gather_model_0"], np.concatenate(row, axis=0))
        np.testing.assert_array_equal(got["gather_model_1"], np.concatenate(row, axis=1))
        np.testing.assert_array_equal(got["gather_data_1"], np.concatenate(col, axis=1))
        np.testing.assert_array_equal(got["psum_model"], np.sum(row, axis=0))
        np.testing.assert_array_equal(got["psum_data"], np.sum(col, axis=0).astype(np.float32))
        # block e of the all-to-all came from model coordinate e's block (this rank's coordinate)
        send = {j: np.arange(m * 2).reshape(m, 2) + 10 * ((r // m) * m + j) for j in range(m)}
        np.testing.assert_array_equal(got["all_to_all"], np.stack([send[j][r % m] for j in range(m)]))


@pytest.mark.parametrize("key", KEYS)
def test_shard_rows_gives_each_rank_its_block(runs, key):
    inputs, outs = runs
    d, m = (int(x) for x in key.split("x"))
    rows = inputs["rows"]
    for r in range(d * m):
        got = outs[r][key]
        padded = np.concatenate([rows, np.zeros(((-10) % m, 4), np.int32)])
        per = padded.shape[0] // m
        np.testing.assert_array_equal(got["rows_model"], padded[(r % m) * per:(r % m + 1) * per])
        joint = np.concatenate([rows, np.zeros(((-10) % (d * m), 4), np.int32)])
        per = joint.shape[0] // (d * m)
        np.testing.assert_array_equal(got["rows_joint"], joint[r * per:(r + 1) * per])
        cols = 4 // m if 4 % m == 0 else None
        np.testing.assert_array_equal(got["rows_axis1"], rows[:, (r % m) * cols:(r % m + 1) * cols])
        assert got["no_pad"] == (None if 7 % m == 0 else f"batch=7 not divisible by {m} shards")


def test_make_mesh_without_a_card_raises_unless_the_cpu_is_asked(runs):
    _, outs = runs
    for out in outs:
        assert out["no_card"] == "make_mesh builds on the GPU by default and none is available: pass device_type='cpu'"

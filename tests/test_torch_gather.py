"""Port row gather (the_algorithm_tpu_torch/ops/gather.py) against the JAX
package's row_gather and its Pallas kernel in interpret mode: a gather
copies, so the comparison is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (one torch thread per worker)

from the_algorithm_tpu.ops import gather as jax_gather
from the_algorithm_tpu_torch.ops import gather


def _tables(rng, R=40):
    return (
        rng.integers(0, 1 << 30, size=(R, 12)).astype(np.int32),
        rng.standard_normal((R, 7)).astype(np.float32),
        rng.integers(-5, 5, size=(R, 3)).astype(np.int32),
    )


def test_plain_matches_jax_row_gather_and_pallas_interpret():
    rng = np.random.default_rng(0)
    tables = _tables(rng)
    ids = rng.integers(0, 40, size=(3, 5)).astype(np.int32)
    got = gather.row_gather(torch.from_numpy(ids), *(torch.from_numpy(t) for t in tables))
    want = jax_gather.row_gather(jnp.asarray(ids), *(jnp.asarray(t) for t in tables))
    want_pallas = jax_gather._row_gather_pallas(
        jnp.asarray(ids.reshape(-1)), *(jnp.asarray(t) for t in tables), interpret=True
    )
    for g, w, wp, t in zip(got, want, want_pallas, tables):
        assert g.shape == (3, 5, t.shape[1]) and g.dtype == torch.from_numpy(t).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy().reshape(15, -1), np.asarray(wp))


def test_bf16_table_is_copied_bit_for_bit():
    t = torch.randn(10, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ids = torch.tensor([9, 0, 9, 3], dtype=torch.int32)
    (got,) = gather.row_gather(ids, t)
    assert torch.equal(got.view(torch.int16), t[ids.long()].view(torch.int16))


@pytest.mark.parametrize("bad", [-1, 40])
def test_out_of_range_ids_raise_on_the_cpu(bad):
    tables = [torch.from_numpy(t) for t in _tables(np.random.default_rng(1))]
    with pytest.raises((IndexError, RuntimeError)):
        gather.row_gather(torch.tensor([0, bad], dtype=torch.int32), *tables)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = gather.row_gather.launches
    gather.row_gather(torch.zeros(2, dtype=torch.int32), torch.ones(3, 4))
    assert gather.row_gather.launches == before


@pytest.mark.parametrize(
    "ids,tables",
    [
        (torch.zeros(2, dtype=torch.int64), (torch.ones(3, 4),)),  # id dtype
        (torch.zeros(2, dtype=torch.int32), (torch.ones(3, 4), torch.ones(5, 4))),  # misaligned R
        (torch.zeros(2, dtype=torch.int32), (torch.ones(3, 4),) * 4),  # k > 3
        (torch.zeros(2, dtype=torch.int32), ()),  # k = 0
        (torch.zeros(2, dtype=torch.int32), (torch.ones(4, 3).T,)),  # not contiguous
        (torch.zeros(2, dtype=torch.int32), (torch.ones(3),)),  # not 2-D
    ],
)
def test_rejects_what_the_kernel_does_not_take(ids, tables):
    with pytest.raises(ValueError):
        gather.row_gather(ids, *tables)


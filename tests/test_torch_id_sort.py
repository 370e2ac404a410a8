"""The sort kernel's selection rule and launch plan (ops/id_sort.py), on the CPU.

The kernel itself runs only on the card (tests/test_torch_kernels.py, ``gpu``
marker); here the rule that picks it, the launch each row width gets, and
the CPU path, which stays the stable sort. This file imports no JAX.
"""

import pytest
import torch

from the_algorithm_tpu_torch.ops import id_sort, retrieval
from the_algorithm_tpu_torch.ops.sparse import PAD_ID

SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory a block can opt in to


# (device, Q, W, k, takes the kernel): every caller of retrieval._dedup_sum at
# its shape, and the edges of the rule
CALLERS = [
    ("cuda", 1024, 20_000, 2, True),  # SANN, the single-device scan (the benchmark's cell)
    ("cuda", 256, 20_000, 2, True),  # the sharded merge at world 1
    ("cuda", 1, 20_000, 2, True),  # tweet-mixer Home's SANN query, the SANN wrapper source
    ("cuda", 32, 256, 2, True),  # UTEG on the For You path
    ("cuda", 1, 512, 2, True),  # Home's UTEG family
    ("cuda", 1, 1536, 2, True),
    ("cuda", 1, 2048, 2, True),
    ("cuda", 256, 4096, 1, True),  # GraphJet UTG
    ("cuda", 1, 4096, 1, True),  # Home's UTG
    ("cuda", 1, 40_960, 1, False),  # hashed_lr's weight gradient: wider than one CTA's row
    ("cuda", 1, 80_000, 2, False),  # the live updates' refreshed-index query
    ("cuda", 4, id_sort.W_MAX, 4, True),
    ("cuda", 4, id_sort.W_MAX + 1, 1, False),
    ("cuda", 4, 64, 5, False),  # more value arrays than one launch carries
    ("cuda", 4, 64, 0, False),
    ("cuda", 0, 64, 1, False),
    ("cuda", 4, 0, 1, False),
    ("cpu", 1024, 20_000, 2, False),
]


@pytest.mark.parametrize("device,Q,W,k,kernel", CALLERS)
def test_the_kernel_engages_by_shape_alone(device, Q, W, k, kernel):
    assert id_sort.engages(device, Q, W, k) is kernel


@pytest.mark.parametrize("W", [1, 3, 33, 256, 512, 1000, 1536, 2048, 4096, 4097, 8193, 12_345, 20_000, id_sort.W_MAX])
def test_each_width_gets_a_launch_the_kernel_takes(W):
    plan = id_sort._plan(W)
    assert plan.ipt in id_sort.IPT and plan.threads % 32 == 0 and 32 <= plan.threads <= id_sort.MAX_THREADS
    assert plan.threads * plan.ipt >= W and plan.threads * plan.ipt < 65_536  # places are 16-bit slots
    assert plan.threads == 32 or (plan.threads - 32) * plan.ipt < W  # no whole warp idle
    assert plan.smem == id_sort.smem_bytes(plan.threads, plan.ipt) <= SMEM_PER_BLOCK


def test_no_launch_past_w_max():
    with pytest.raises(ValueError):
        id_sort._plan(id_sort.W_MAX + 1)


def test_on_the_cpu_the_sort_is_the_stable_sort():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-5, 5, (6, 300), generator=g, dtype=torch.int32)
    ids[0] = PAD_ID
    vals = [torch.randn((6, 300), generator=g) for _ in range(3)]
    before = id_sort.sort_by_id.launches
    got = retrieval.sort_by_id(ids, *vals)
    assert id_sort.sort_by_id.launches == before
    want_ids, order = torch.sort(ids, dim=-1, stable=True)
    assert torch.equal(got[0], want_ids)
    for g_, v in zip(got[1:], vals):
        assert torch.equal(g_, torch.take_along_dim(v, order, dim=-1))

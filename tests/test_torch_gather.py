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


# ---- the launch plan (pure: the CPU checks every plan the card would run) ----

SMS = 132  # an H100 SXM
SMEM_PER_BLOCK = 232_448  # 227 KB: the most dynamic shared memory a block can opt in to
SMEM_PER_SM = 233_472  # 228 KB on each SM, of which the card keeps 1 KB per resident block
SMEM_RESERVED = 1024
RING_SHAPES = [gather.RING, gather.RingShape(32 * 1024, 4, 8), gather.RingShape(16 * 1024, 2, 12),
               gather.RingShape(4 * 1024, 2, 3)]  # the default and shapes like those chip_smoke.py tries
ALIGNED = 1 << 20  # a 16-byte aligned base address

PLAN_SHAPES = [  # (row bytes of each table, rows)
    ([1600, 1600, 1600], 12_800),  # the SANN cluster-row fetch
    ([256], 16_384), ([512], 16_384), ([16], 262_144),  # hydration widths
    ([16], 1), ([1600, 1600, 1600], 1), ([256], 5), ([64], 33),
    ([48, 1600, 32], 3000), ([16, 256], 100_000), ([27_296], 2048),
    ([131_072], 64), ([131_072], 1056), ([131_072], 1057),
    ([16, 131_072, 400], 77), ([1 << 20], 3), ([32_768], 10), ([32_768, 16], 10),
    ([16_400, 16_400], 1), ([65_536], 1024), ([65_536], 4096), ([16_384], 7), ([8192, 8192], 100_000),
    ([28], 262_144), ([28, 12, 180], 20_001), ([4], 7), ([40_004], 10),  # 4-byte words
]


def _ring_units(row_bytes, B, plan):
    """Each unit of the ring's work as (table, output row, byte offset, length,
    stage offset), in the kernel's order: whole rows of all tables, their
    tables side by side in the stage, or one piece of one table's row."""
    if plan.rows_per_stage:
        r = plan.rows_per_stage
        units = []
        for first in range(0, B, r):
            copies, off = [], 0
            for j, b in enumerate(row_bytes):
                copies += [(j, row, 0, b, r * off + (row - first) * b) for row in range(first, min(B, first + r))]
                off += b
            units.append(copies)
        return units
    return [[(j, row, off, min(plan.piece, b - off), 0)]
            for row in range(B) for j, b in enumerate(row_bytes) for off in range(0, b, plan.piece)]


@pytest.mark.parametrize("ring", RING_SHAPES)
@pytest.mark.parametrize("row_bytes,B", PLAN_SHAPES)
def test_plan_fits_the_card_and_covers_the_work(row_bytes, B, ring, monkeypatch):
    monkeypatch.setattr(gather, "RING", ring)
    plan = gather._plan(row_bytes, [ALIGNED] * (2 * len(row_bytes)), B, SMS)
    assert plan.path == ("ring" if all(b % 16 == 0 for b in row_bytes) else "words")
    if plan.path == "words":  # the C entry sizes the register kernel's launch
        return
    units = _ring_units(row_bytes, B, plan)
    assert 1 <= plan.grid <= len(units)  # no CTA without a unit of work
    assert plan.stages >= 2 and plan.stage_bytes % 16 == 0
    assert plan.smem == plan.stages * (plan.stage_bytes + 8) <= SMEM_PER_BLOCK
    # persistent: every CTA of the grid is resident at once
    resident = SMEM_PER_SM // (plan.smem + SMEM_RESERVED)
    assert plan.grid <= SMS * min(resident, ring.ctas_per_sm)
    if plan.rows_per_stage:  # whole rows, as many as the stage budget holds
        assert plan.stage_bytes == plan.rows_per_stage * sum(row_bytes) <= ring.stage_bytes
        assert plan.piece == 0
    else:  # a row wider than the budget: pieces of one table's row
        assert sum(row_bytes) > ring.stage_bytes and plan.stage_bytes == plan.piece
    # every (table, row) is copied once, whole, in 16-byte-aligned copies within a stage
    seen = {}
    for copies in units:
        assert sum(n for _, _, _, n, _ in copies) <= plan.stage_bytes
        for j, row, off, n, at in copies:
            assert off % 16 == 0 and n % 16 == 0 and at % 16 == 0 and 0 < n and at + n <= plan.stage_bytes
            seen[j, row] = seen.get((j, row), 0) + n
    assert seen == {(j, row): b for j, b in enumerate(row_bytes) for row in range(B)}


def test_plan_splits_a_row_wider_than_a_stage_into_16_byte_pieces():
    plan = gather._plan([131_072], [ALIGNED, ALIGNED], 64, SMS)
    assert plan.path == "ring" and plan.rows_per_stage == 0
    assert plan.piece % 16 == 0 and plan.piece < 131_072
    assert [n for (_, _, _, n, _), in _ring_units([131_072], 1, plan)] == [plan.piece] * (131_072 // plan.piece)
    assert plan.smem > 48 * 1024  # the launch must opt in to more shared memory than the default


@pytest.mark.parametrize(
    "row_bytes,ptrs,B,path",
    [
        ([1600, 1600, 1600], [ALIGNED] * 6, 100, "ring"),
        ([1600, 1600, 1600], [ALIGNED] * 5 + [ALIGNED + 4], 100, "words"),  # one base off by 4 bytes
        ([16, 32], [ALIGNED, ALIGNED + 8, ALIGNED, ALIGNED], 100, "words"),
        ([28], [ALIGNED] * 2, 100, "words"),  # 28-byte rows: no bulk copy
        ([1600, 12], [ALIGNED] * 4, 100, "words"),  # one table decides for all
        ([131_072], [ALIGNED] * 2, 100, "ring"),  # wide and few
        ([131_072], [ALIGNED] * 2, 100_000, "ring"),  # wide and many
        ([131_072], [ALIGNED + 4, ALIGNED], 100, "words"),  # wide, 4-byte aligned
    ],
)
def test_plan_picks_the_path_by_alignment_width_and_count(row_bytes, ptrs, B, path):
    assert gather._plan(row_bytes, ptrs, B, SMS).path == path


@pytest.mark.parametrize("row_bytes,ptrs", [([14], [ALIGNED] * 2), ([16], [ALIGNED, ALIGNED + 2])])
def test_plan_refuses_what_no_kernel_copies(row_bytes, ptrs):
    with pytest.raises(ValueError):
        gather._plan(row_bytes, ptrs, 10, SMS)


def test_sann_plan_is_persistent_and_fills_every_sm():
    plan = gather._plan([1600] * 3, [ALIGNED] * 6, 12_800, SMS)
    assert plan.path == "ring" and plan.rows_per_stage == 16 * 1024 // 4800
    # 12,800 rows give every CTA more units than its stages, and every SM holds
    # as many CTAs as its shared memory fits: three rings of 57.6 KB
    assert plan.grid == SMS * (SMEM_PER_SM // (plan.smem + SMEM_RESERVED)) == SMS * 3
    assert -(-12_800 // plan.rows_per_stage) > plan.grid * plan.stages


@pytest.mark.parametrize("B", [1, 5, 1583, 1584, 1585, 4753, 50_000])
def test_plan_gives_small_batches_more_ctas_not_fuller_stages(B):
    plan = gather._plan([256], [ALIGNED] * 2, B, SMS)
    ctas = SMS * gather.RING.ctas_per_sm  # narrow rows: the stages fit that many on an SM
    # the fewest rows per stage that still leave every CTA two units of work
    assert plan.rows_per_stage == min(gather.RING.stage_bytes // 256, -(-B // (2 * ctas)))
    assert plan.grid == min(ctas, -(-B // plan.rows_per_stage))

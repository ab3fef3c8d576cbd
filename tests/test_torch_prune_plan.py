"""Kγ's launch plan (graph/heuristic.py prune_plan) on the CPU: the shared
memory it asks for stays within what one block of the card can have, and it
raises rather than plan a launch that cannot fit. Staged rows are fp32 for
both store dtypes (a bf16 row is widened as it is staged), so the plan is
the same for both; the wrapper is checked to run either on the CPU."""

import pytest
import torch

from hnsw_slim_tpu_torch.graph import heuristic as th

LIMIT = 232448  # 227 KB: the most shared memory one block can have


def _smem(c, d, m_slots, ring):
    """The dynamic bytes csrc/rng_prune.cu lays out for this plan: every
    candidate's row and one more (the base row's), or two rings and the
    kept rows, at a stride 8 mod 32 floats, then the per-candidate and
    per-kept-row arrays."""
    stride = -(-d // 32) * 32 + 8
    cp = 1 << (max(c, 32) - 1).bit_length()
    rows = c + 1 if ring >= c else 2 * ring + m_slots
    return 4 * stride * rows + 4 * cp * 3 + 4 * m_slots * 3 + cp


def _fits(nbytes):
    return nbytes + th.SMEM_STATIC <= LIMIT


@pytest.mark.parametrize("d", [1, 4, 100, 128, 960, 1024])
@pytest.mark.parametrize("c", [1, 31, 32, 60, 64, 65, 128, 150, 300, 1024,
                               4096])
def test_prune_plan_fits_a_block(c, d):
    for m in sorted({1, 16, 30, 60, min(c, 64), c}):
        if m > c:
            continue
        for slots in (m, c):  # a budget's kept rows; the guarded mode's C
            stage_all = c <= th.STAGE_ALL and _fits(_smem(c, d, slots, c))
            try:
                plan = th.prune_plan(c, d, slots)
            except ValueError:
                # nothing fits: neither every row staged nor one ring row
                # beside the kept rows
                assert not stage_all and not _fits(_smem(c, d, slots, 1))
                continue
            assert plan.smem == _smem(c, d, slots, plan.ring)
            assert _fits(plan.smem)
            if stage_all:
                assert plan.ring == c and plan.threads == 128
                continue
            assert plan.threads == 256
            # the ring form: fewer rows than C, the largest halving of
            # RING that fits
            first = min(th.RING, c - 1)
            assert 1 <= plan.ring <= first
            if plan.ring < first:
                assert not _fits(_smem(c, d, slots, 2 * plan.ring))


def test_prune_plan_main_path_shapes():
    """The conversion's rows (C 60, guarded: 60 kept rows) stage every
    candidate, in blocks of 128 threads; the insert forward prune (C 128,
    d 128), the overflow re-prune and a 1024-wide hub row take a full ring
    beside their kept rows, in blocks of 256."""
    for c, m in ((60, 60), (64, 32), (16, 16)):
        assert th.prune_plan(c, 128, m)[::2] == (c, 128)
    for c, m in ((128, 30), (150, 60), (1024, 60)):
        assert th.prune_plan(c, 128, m)[::2] == (th.RING, 256)


def test_prune_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError):
        th.prune_plan(4096, 1024, 4096)
    with pytest.raises(ValueError):
        th.prune_plan(1024, 128, 1024)
    # the ring shrinks before the plan gives up, and a row too wide to
    # stage every candidate takes the ring form
    assert th.prune_plan(4096, 1024, 40).ring < th.RING
    assert th.prune_plan(64, 1024, 30).ring < 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rng_prune_cpu_path_ignores_plan(dtype):
    """On CPU tensors the wrapper runs the plain version, whatever the
    shape: a 1024-wide guarded row at d 128, which no block could hold,
    still prunes (in either store dtype)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3000, 128, generator=g).to(dtype)
    xn = (x.float() ** 2).sum(1)
    base = torch.arange(4, dtype=torch.int32)
    cand = torch.randint(0, 3000, (4, 1024), generator=g, dtype=torch.int32)
    guard = torch.rand(4, 1024, generator=g) < 0.01
    m = torch.full((4,), 8, dtype=torch.int32)
    sel, cnt = th.rng_prune(x, xn, base, cand, m, keep_all_under_m=False,
                            keep_pruned=False, out_width=32, guard=guard)
    assert sel.shape == (4, 32) and (cnt >= 1).all()
    with pytest.raises(ValueError):
        th.prune_plan(1024, 128, 1024)

"""The launch plan of the stream kernels B5 / B6 (`stream_plan`,
qdiffusion_torch/ops/int8_matmul.py) at every product shape of one SD v1
stream UNet call at batch 2 (CFG of batch 1, 64x64 latents), on the CPU:
the plan is host arithmetic, so its coverage, split boundaries, grid
size and determinism are checked here without the card.

The shapes are the fixed lists beside the plan (`SD_STREAM_W4`,
`SD_STREAM_W8`), written out there from the UNet's config and the stream
engine's byte cost model; the card bench times the same lists.
"""

import pytest

from qdiffusion_torch.ops.int8_matmul import SD_STREAM_W4, SD_STREAM_W8, \
    STREAM_BN, STREAM_MIN_STAGES, STREAM_SPLIT_CAP, STREAM_TILE_ROWS, \
    STREAM_WAVE, STREAM_X_STAGE, stream_plan

CASES = [(s, True) for s in SD_STREAM_W4] + [(s, False) for s in SD_STREAM_W8]
IDS = [f"{'B6' if i4 else 'B5'}-{m}x{k}x{n}" for (m, k, n), i4 in CASES]
SMS = 132  # H100 SXM


def test_the_shape_lists_are_one_call():
    """220 B6 calls per W4 UNet call and 34 B5 calls per W8 call, as the
    chip smoke's spies count them (PERF.md section 4)."""
    assert sum(SD_STREAM_W4.values()) == 220
    assert sum(SD_STREAM_W8.values()) == 34


@pytest.mark.parametrize("shape,int4", CASES, ids=IDS)
def test_plan_covers_every_output_and_k_row_once(shape, int4):
    M, K, N = shape
    p = stream_plan(M, N, K, int4, SMS)
    gx, gy, gz = p.grid
    assert gz == p.splits
    assert p.bn == STREAM_BN and p.bm in STREAM_TILE_ROWS
    cols = [0] * N
    for bx in range(gx):
        for n in range(bx * p.bn, min((bx + 1) * p.bn, N)):
            cols[n] += 1
    assert cols == [1] * N and (gx - 1) * p.bn < N
    assert gy * p.bm >= M > (gy - 1) * p.bm
    rows = [0] * p.kw
    xcols = [0] * K
    for s in range(p.splits):
        lo, hi = s * p.kps, min((s + 1) * p.kps, p.kw)
        assert lo < hi  # no empty split
        for k in range(lo, hi):
            rows[k] += 1
            xcols[k] += 1
            if int4:  # the high nibbles: x columns K/2 + k
                xcols[K // 2 + k] += 1
    assert rows == [1] * p.kw and xcols == [1] * K
    assert p.kw == (K // 2 if int4 else K)


@pytest.mark.parametrize("shape,int4", CASES, ids=IDS)
def test_plan_splits_on_stage_boundaries(shape, int4):
    M, K, N = shape
    p = stream_plan(M, N, K, int4, SMS)
    assert p.stage_rows == STREAM_X_STAGE // (2 if int4 else 1)
    assert p.kps % p.stage_rows == 0
    stages = -(-p.kw // p.stage_rows)
    if p.splits > 1:
        assert p.kps // p.stage_rows >= STREAM_MIN_STAGES
    assert (p.splits - 1) * p.kps < p.kw <= p.splits * p.kps
    assert -(-stages // (p.kps // p.stage_rows)) == p.splits


@pytest.mark.parametrize("shape,int4", CASES, ids=IDS)
def test_plan_fills_about_one_wave_or_the_split_cap(shape, int4):
    """A wave here is STREAM_WAVE blocks per SM. A grid of fewer output
    tiles is split until it reaches a wave, the split cap, or the fewest
    stages a split may walk."""
    M, K, N = shape
    p = stream_plan(M, N, K, int4, SMS)
    assert p.bm == (16 if M <= 16 else 32)
    tiles = p.grid[0] * p.grid[1]
    wave = STREAM_WAVE * SMS
    stages = -(-p.kw // p.stage_rows)
    cap = min(STREAM_SPLIT_CAP, max(1, stages // STREAM_MIN_STAGES))
    if tiles >= wave:
        assert p.splits == 1
    else:
        # a wave, the cap, or one split short of either where whole
        # stages do not divide evenly (e.g. 12 stages over 5 splits take
        # 4 splits of 3)
        assert tiles * (p.splits + 1) >= wave or p.splits + 1 >= cap
        assert 1 <= p.splits <= cap
        # no more splits than a wave needs
        assert tiles * (p.splits - 1) < wave


@pytest.mark.parametrize("shape,int4", CASES, ids=IDS)
def test_plan_is_deterministic(shape, int4):
    M, K, N = shape
    plans = {stream_plan(M, N, K, int4, SMS) for _ in range(3)}
    assert len(plans) == 1
    # another card's SM count gives its own plan, again deterministically
    assert stream_plan(M, N, K, int4, 114) == stream_plan(M, N, K, int4, 114)


def _covers_once(p):
    """Every weight row in exactly one non-empty split, on stage
    boundaries."""
    assert p.kps % p.stage_rows == 0
    rows = [0] * p.kw
    for s in range(p.splits):
        lo, hi = s * p.kps, min((s + 1) * p.kps, p.kw)
        assert lo < hi
        for k in range(lo, hi):
            rows[k] += 1
    return rows == [1] * p.kw


# a few shapes of each tile, at the split counts the card bench sweeps
SWEPT = [((2, 1280, 1280), True), ((128, 23040, 1280), True),
         ((154, 768, 320), True), ((2048, 1920, 640), False),
         ((128, 11520, 1280), False), ((8192, 320, 2560), True)]


@pytest.mark.parametrize("splits", (1, 2, 3, 4, 6, 8, 12, 16))
@pytest.mark.parametrize("shape,int4", SWEPT,
                         ids=[f"{'B6' if i4 else 'B5'}-{m}x{k}x{n}"
                              for (m, k, n), i4 in SWEPT])
def test_forced_split_count(shape, int4, splits):
    """`stream_plan(..., splits=s)` keeps the plan's tile and covers K once
    in s splits, or in as many as whole stages fill (never more than s)."""
    M, K, N = shape
    auto = stream_plan(M, N, K, int4, SMS)
    p = stream_plan(M, N, K, int4, SMS, splits=splits)
    assert (p.bm, p.bn, p.kw, p.stage_rows) == \
        (auto.bm, auto.bn, auto.kw, auto.stage_rows)
    assert p.grid == (auto.grid[0], auto.grid[1], p.splits)
    stages = -(-p.kw // p.stage_rows)
    assert 1 <= p.splits <= min(splits, stages)
    assert _covers_once(p)
    assert stream_plan(M, N, K, int4, SMS, splits=auto.splits) == auto

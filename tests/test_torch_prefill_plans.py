"""Shape logic of the prefill kernels K1 (tiled W4A16 GEMM), K3/K7 (flash
prefill over bf16 / INT8 KV) and K10 (MLA prefill) in the port, checked
without a card: K1's plan over the Hopper mainloop (`k1_plan`,
`k1_choice`), K3/K7's per-block KV tile ranges (`prefill_tile_ranges`) and
K10's row blocks and latent splits (`mla_prefill_plan`), which the CUDA
sources compute the same way; and the prefill wrappers' refusal of what
their kernels cannot launch."""

import itertools

import numpy as np
import pytest
import torch

from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
from tensorrt_llm_tpu_torch.ops.flash_prefill import (
    PREFILL_ROWS, PREFILL_TILE, flash_prefill_attention, prefill_tile_ranges)
from tensorrt_llm_tpu_torch.ops.mla import (
    _K10_TILE_RECORDS, MLA_ROWS, MLA_TILE, mla_prefill_attention,
    mla_prefill_plan, mla_prefill_split_choices)

PLAN_M = (17, 128, 200, 255, 256, 300, 512)

# (K, N) of the tiled W4A16 projections the serve paths run (the shapes
# their autotuner keys name): TinyLlama-1.1B and Llama-3-8B qkv / o /
# gate_up / down, GPT-OSS-20B qkv, Moonlight-16B-A3B and DeepSeek-V3.2's
# dense, shared-expert and attention projections
SERVED_TILED = [
    (2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
    (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
    (2880, 5120),
    (2048, 3072), (2048, 5632), (2048, 22528), (2816, 2048), (11264, 2048),
    (1536, 24576), (2048, 7168), (7168, 1536), (7168, 4096), (7168, 36864),
    (16384, 7168), (18432, 7168),
]


def _check_plan(M, K, N, plan):
    n_st = -(-K // W.SM90_STAGE_K)
    starts = plan["stage_start"]
    assert starts[0] == 0 and starts[-1] == n_st
    sizes = np.diff(starts)
    assert (sizes > 0).all(), starts            # K order, no empty slice
    assert sizes.max() - sizes.min() <= 1, starts   # uneven by one stage
    assert len(sizes) == plan["slices"] <= W.K1_MAX_SLICES
    assert plan["n_mb"] * plan["ntok"] >= M > (plan["n_mb"] - 1) * plan["ntok"]
    assert plan["n_ct"] * plan["cols"] >= N > (plan["n_ct"] - 1) * plan["cols"]
    assert plan["units"] == plan["n_mb"] * plan["n_ct"] * plan["slices"]
    assert 0 < plan["grid"] <= min(plan["units"], plan["slots"])


@pytest.mark.parametrize("M", PLAN_M)
@pytest.mark.parametrize("K,N", SERVED_TILED)
def test_k1_plan_covers_k_in_stages(M, K, N):
    """Every served tiled shape is planned; the slices cover K in whole
    64-row stages, in K order, and the units cover every row and column."""
    _check_plan(M, K, N, W.k1_plan(M, K, N))


@pytest.mark.parametrize("M", PLAN_M)
def test_k1_units_fill_the_card(M):
    """Where whole-K units would leave more than half of the block slots
    idle and K has stages to cut, the plan cuts K; the grid never exceeds
    the slots."""
    for K, N in SERVED_TILED:
        plan = W.k1_plan(M, K, N)
        tiles = plan["n_mb"] * plan["n_ct"]
        n_st = -(-K // W.SM90_STAGE_K)
        if 2 * tiles < plan["slots"] and n_st >= 2:
            assert plan["slices"] > 1, (M, K, N, plan)
            assert plan["units"] >= min(plan["slots"] // 2,
                                        tiles * min(n_st, W.K1_MAX_SLICES))
        assert plan["grid"] <= plan["slots"]


def test_k1_choice_is_the_model_minimum():
    """`k1_choice` takes the configuration and slice count of least
    modeled time over the path's configurations (one below 128 tokens)."""
    for (K, N), M in itertools.product(SERVED_TILED[:9], PLAN_M):
        v, d = W.k1_choice(M, K, N)
        variants = W.K1_PATH_VARIANTS if M > 64 else W.K1_PATH_VARIANTS[:1]
        assert v in variants
        best = min(W.k1_model_s(M, K, N, dd, vv)
                   for vv in variants for dd in W.k1_slice_choices(K))
        assert W.k1_model_s(M, K, N, d, v) <= best * (1 + 1e-9)


def _old_k1_accepts(K, N, G, bn):
    """The reach K1 keeps: the shapes the tiled kernels' operand check
    takes (BN % 64 == 0 dividing N, K % 32 == 0, G % 32 == 0 dividing
    K)."""
    return bn % 64 == 0 and N % bn == 0 and K % 32 == 0 and G % 32 == 0 \
        and K % G == 0


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_k1_refuses_no_shape_the_first_k1_took(bn):
    """Any K % 32 == 0 (a K % 64 == 32 tail is half a stage) and any
    G % 32 == 0 dividing K, G = K included, at any M: the operand check
    passes and the plan builds."""
    N = 2 * bn
    for K in range(32, 1025, 32):
        for G in [g for g in range(32, K + 1, 32) if K % g == 0]:
            assert _old_k1_accepts(K, N, G, bn)
            W.tiled_check(K, G, bn)
            for M in (1, 17, 130, 300):
                _check_plan(M, K, N, W.k1_plan(M, K, N))
    for K, G in ((48, 16), (96, 48), (64, 16)):
        with pytest.raises(NotImplementedError):
            W.tiled_check(K, G, bn)


def test_k1_plan_overrides():
    """`variant` and `slices` pin the configuration and the K cut; a
    slice count past the stages or past the cap is refused."""
    plan = W.k1_plan(256, 2880, 5120, variant=0, slices=5)
    assert plan["variant"] == 0 and plan["slices"] == 5
    assert W.k1_tiles(256, 3) == (128, 3)
    assert W.k1_tiles(17, 3) == (32, 1)
    with pytest.raises(ValueError):
        W.k1_plan(256, 128, 256, slices=3)        # two stages
    with pytest.raises(ValueError):
        W.k1_plan(256, 2880, 5120, slices=W.K1_MAX_SLICES + 1)
    with pytest.raises(ValueError):
        W.k1_plan(256, 2880, 5120, variant=len(W.K1_VARIANTS))


def _valid_pairs(T, G, kv_len, q_offset, window):
    """numpy: [rows, kv_len] mask of the (row, KV position) pairs the
    kernel's masks keep (row = token x G + head)."""
    tok = np.arange(T * G) // G
    qpos = (q_offset + tok)[:, None]
    kpos = np.arange(kv_len)[None, :]
    keep = (kpos <= qpos) & (kpos < kv_len)
    if window:
        keep &= kpos > qpos - window
    return keep


@pytest.mark.parametrize("T,G,q_offset,window", [
    (256, 4, 256, None), (17, 4, 1024, None), (100, 8, 37, 128),
    (5, 4, 3, None), (300, 1, 0, 96), (129, 4, 200, 64), (64, 8, 0, None),
    (1, 8, 500, 16), (77, 2, 64, 1),
])
def test_k7_tile_ranges_cover_exactly_the_valid_pairs(T, G, q_offset,
                                                      window):
    """Each block's tile range holds every valid pair of its rows, and
    each of its tiles holds at least one: the skipped tiles are exactly
    those no mask keeps (causal edge, window, ragged last block)."""
    kv_len = q_offset + T
    keep = _valid_pairs(T, G, kv_len, q_offset, window)
    ranges = prefill_tile_ranges(T, G, kv_len, q_offset, window)
    assert len(ranges) == -(-T * G // PREFILL_ROWS)
    n_tiles = -(-kv_len // PREFILL_TILE)
    for b, (t0, t1) in enumerate(ranges):
        rows = keep[b * PREFILL_ROWS:(b + 1) * PREFILL_ROWS]
        per_tile = np.add.reduceat(rows.sum(0), np.arange(
            0, kv_len, PREFILL_TILE)) if kv_len else np.zeros(0)
        assert per_tile.shape == (n_tiles,)
        inside = np.zeros(n_tiles, bool)
        inside[t0:t1] = True
        assert (per_tile[~inside] == 0).all(), (b, t0, t1)
        assert (per_tile[inside] > 0).all(), (b, t0, t1)
        # the two consumer warpgroups take alternate tiles of the range
        halves = [range(t0 + w, t1, 2) for w in (0, 1)]
        assert sorted(itertools.chain(*halves)) == list(range(t0, t1))


@pytest.mark.parametrize("q_offset", [0, 37, 256, 1024])
@pytest.mark.parametrize("T", [1, 17, 100, 256])
@pytest.mark.parametrize("H", [16, 128])
def test_k10_plan_covers_exactly_the_valid_pairs(H, T, q_offset):
    """Each row block's latent range holds every (row, latent position)
    pair the masks keep (kv_pos <= q_pos, kv_pos < kv_len), and each of its
    tiles holds at least one; the splits, whole 64-token tiles, cut every
    range into disjoint runs, so each kept pair falls in one split of one
    block; blocks x splits stay within one wave of the 132 SMs (K10 holds
    one block an SM) unless the blocks alone exceed it, and of the split
    lengths that fit, the plan's has the least modelled time: its tiles,
    plus, when split, the merge's partial records (64 rows a live block
    split) at `_K10_TILE_RECORDS` records a tile."""
    kv_len = q_offset + T
    R = T * H
    blocks, n_splits, split_len, ranges = mla_prefill_plan(T, H, kv_len,
                                                           q_offset)
    assert blocks == len(ranges) == -(-R // MLA_ROWS)
    assert split_len > 0 and split_len % MLA_TILE == 0
    per = split_len // MLA_TILE
    # row r keeps the latent positions [0, lim[r])
    lim = np.minimum(kv_len, q_offset + np.arange(R) // H + 1)
    for b, (t0, t1) in enumerate(ranges):
        reach = lim[b * MLA_ROWS:(b + 1) * MLA_ROWS].max()
        tiles_kept = np.arange(-(-kv_len // MLA_TILE)) * MLA_TILE < reach
        inside = np.zeros_like(tiles_kept)
        inside[t0:t1] = True
        assert (tiles_kept == inside).all(), (b, t0, t1, reach)
        covered = [j for s in range(n_splits)
                   for j in range(max(t0, s * per), min(t1, (s + 1) * per))]
        assert covered == list(range(t0, t1)), (b, n_splits, per)
    longest = max(t1 for _, t1 in ranges)
    assert n_splits == -(-longest // per)
    assert blocks * n_splits <= max(132, blocks)

    def cost(p):
        live = sum(-(-(t1 - t0) // p) for t0, t1 in ranges)
        merged = -(-longest // p) > 1
        return p + (MLA_ROWS * live / _K10_TILE_RECORDS if merged else 0)
    fits = [p for p in range(1, longest + 1)
            if blocks * -(-longest // p) <= 132]
    if fits:
        assert cost(per) == min(cost(p) for p in fits), (per, fits)
    else:
        assert per == longest


@pytest.mark.parametrize("H,T,q_offset", [
    (16, 256, 256), (16, 17, 1024), (128, 17, 1024), (128, 256, 0)])
def test_k10_split_choices_take_every_split_count(H, T, q_offset):
    """The split lengths the chip check times against the plan: whole
    tiles, one per distinct split count from 1 to one tile a split, the
    plan's own among them."""
    kv_len = q_offset + T
    choices = mla_prefill_split_choices(T, H, kv_len, q_offset)
    tiles = -(-kv_len // MLA_TILE)
    assert all(c % MLA_TILE == 0 for c in choices)
    counts = [-(-tiles * MLA_TILE // c) for c in choices]
    assert sorted(set(counts)) == sorted(
        {-(-tiles // -(-tiles // n)) for n in range(1, tiles + 1)})
    assert min(choices) == MLA_TILE and max(choices) == tiles * MLA_TILE
    assert mla_prefill_plan(T, H, kv_len, q_offset)[2] in choices


REFUSED = [
    # wrapper, page size, INT8 pool, what it raises
    ("mla_prefill", 16, False, ValueError),        # the device
    ("mla_prefill", 12, False, NotImplementedError),   # not a TMA box
    ("flash_prefill", 16, False, ValueError),
    ("flash_prefill", 12, False, NotImplementedError),
    ("flash_prefill", 4, False, NotImplementedError),
    ("flash_prefill", 12, True, ValueError),      # K7 takes any page size
]


@pytest.mark.parametrize("kernel,BS,int8,exc", REFUSED)
def test_prefill_wrappers_refuse_instead_of_falling_back(kernel, BS, int8,
                                                         exc):
    """Only a CPU tensor takes the plain version: a tensor on any other
    device goes to the kernel path, which raises on what its kernel cannot
    launch (page sizes off the TMA boxes, or the device itself)."""
    table = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(exc):
        if kernel == "mla_prefill":
            q = torch.zeros((17, 16, 576), dtype=torch.bfloat16,
                            device="meta")
            pool = torch.zeros((5, 1, BS, 576), dtype=torch.bfloat16,
                               device="meta")
            mla_prefill_attention(q, pool, table, 54, 37, 0.1, 512)
        else:
            q = torch.zeros((17, 32, 128), dtype=torch.bfloat16,
                            device="meta")
            shape = (5, 8, BS, 128)
            if int8:
                pool = (torch.zeros(shape, dtype=torch.int8, device="meta"),
                        torch.zeros(shape[:3], device="meta"))
            else:
                pool = torch.zeros(shape, dtype=torch.bfloat16,
                                   device="meta")
            flash_prefill_attention(q, pool, pool, table, 54, 37, 0.1)

"""Shape logic of the decode-side DeepSeek kernels K9 (absorbed MLA decode)
and K11 (DSA indexer scores) in the port, checked without a card: K9's
head blocks and latent splits (`mla_decode_plan`, one thread block cluster
of splits per sequence and head block) and K11's tiles a block
(`dsa_score_plan`), which the CUDA sources read the same way; the split
and tile choices the chip check times against the plans; and both
wrappers' refusal of what their kernels cannot launch."""

import pytest
import torch

from tensorrt_llm_tpu_torch.ops.dsa import (
    DSA_BLOCKS_PER_SM, DSA_MAX_TILES, DSA_TILE, dsa_score_plan,
    dsa_score_tile_choices, dsa_scores)
from tensorrt_llm_tpu_torch.ops.mla import (
    MLA_DECODE_BLOCKS, MLA_DECODE_MAX_SPLITS, MLA_ROWS, MLA_TILE,
    mla_decode_attention, mla_decode_plan, mla_decode_split_choices)

SMS = 132
# table widths (tokens): pages of 16 up to the served V3.2 table (190
# pages), K11's 517-page case, and widths off the 64-token tile
TABLES = [16, 64, 100, 1000, 3040, 4000, 8272]


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("H", [1, 16, 64, 100, 128])
@pytest.mark.parametrize("B", [1, 4, 32])
def test_k9_plan_covers_every_head_and_slot_once(B, H, table):
    """Head blocks of `MLA_ROWS` cover the H heads; the splits, whole
    64-token tiles, cut the table's slots into disjoint runs, none starting
    past the table, at most a cluster's 16; B x head blocks x splits stay
    within the blocks the card runs at once in such clusters unless the
    (sequence, head block) pairs alone exceed them, with the most splits
    that fit."""
    hb, n, split_len = mla_decode_plan(B, H, table)
    assert hb * MLA_ROWS >= H > (hb - 1) * MLA_ROWS
    assert split_len > 0 and split_len % MLA_TILE == 0
    assert 1 <= n <= MLA_DECODE_MAX_SPLITS
    owner = [s for s in range(n)
             for _ in range(max(0, min(split_len, table - s * split_len)))]
    assert owner == sorted(owner) and len(owner) == table   # once each
    assert (n - 1) * split_len < table     # no split starts past it
    assert B * hb * n <= max(MLA_DECODE_BLOCKS, B * hb)
    tiles = -(-table // MLA_TILE)
    per = split_len // MLA_TILE
    if per > 1:
        # one tile shorter would take more splits than a cluster or a wave
        more = -(-tiles // (per - 1))
        assert more > MLA_DECODE_MAX_SPLITS \
            or B * hb * more > MLA_DECODE_BLOCKS


@pytest.mark.parametrize("table", TABLES)
def test_k9_split_choices_take_every_split_count(table):
    """The split lengths the chip check times against the plan: whole
    tiles, one per distinct split count from 1 to the cluster limit, the
    plan's own among them."""
    choices = mla_decode_split_choices(table)
    tiles = -(-table // MLA_TILE)
    assert all(c % MLA_TILE == 0 for c in choices)
    counts = sorted(-(-table // c) for c in choices)
    assert counts == sorted({-(-tiles // -(-tiles // n))
                             for n in range(1, min(tiles, 16) + 1)})
    assert max(counts) <= MLA_DECODE_MAX_SPLITS
    for B, H in ((1, 16), (4, 16), (4, 128), (32, 128)):
        assert mla_decode_plan(B, H, table)[2] in choices


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("B", [1, 4, 32, 256])
def test_k11_plan_covers_every_slot_once(B, table):
    """A block scores `tiles` consecutive 64-token tiles of one sequence:
    the blocks cover every slot of the table once, none starts past it,
    and B x blocks stay within the card's resident blocks (two an SM)
    unless a block already takes the most tiles or every tile."""
    per, blocks = dsa_score_plan(B, table)
    n_tiles = -(-table // DSA_TILE)
    assert 1 <= per <= min(DSA_MAX_TILES, n_tiles)
    owner = [k for k in range(blocks)
             for _ in range(max(0, min(per * DSA_TILE,
                                       table - k * per * DSA_TILE)))]
    assert owner == sorted(owner) and len(owner) == table
    assert (blocks - 1) * per * DSA_TILE < table
    slots = DSA_BLOCKS_PER_SM * SMS
    assert B * blocks <= slots or per == min(DSA_MAX_TILES, n_tiles)
    if per > 1:
        # one tile fewer a block would overflow the resident blocks
        assert B * -(-n_tiles // (per - 1)) > slots


@pytest.mark.parametrize("table", TABLES)
def test_k11_tile_choices_include_the_plan(table):
    choices = dsa_score_tile_choices(table)
    assert choices == list(range(1, min(-(-table // DSA_TILE),
                                        DSA_MAX_TILES) + 1))
    for B in (1, 4, 32):
        assert dsa_score_plan(B, table)[0] in choices


REFUSED = [
    # wrapper, page size, what it raises
    ("mla_decode", 16, ValueError),             # the device
    ("mla_decode", 12, NotImplementedError),    # not a TMA box
    ("mla_decode", 4, NotImplementedError),
    ("dsa_score", 16, ValueError),
    ("dsa_score", 12, NotImplementedError),
    ("dsa_score", 4, NotImplementedError),
]


@pytest.mark.parametrize("kernel,BS,exc", REFUSED)
def test_decode_wrappers_refuse_instead_of_falling_back(kernel, BS, exc):
    """Only a CPU tensor takes the plain version: a tensor on any other
    device goes to the kernel path, which raises on what its kernel cannot
    launch (page sizes off the TMA boxes, or the device itself)."""
    tables = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    kv_lens = torch.ones((2,), dtype=torch.int32, device="meta")
    with pytest.raises(exc):
        if kernel == "mla_decode":
            q = torch.zeros((2, 16, 576), dtype=torch.bfloat16,
                            device="meta")
            pool = torch.zeros((9, 1, BS, 576), dtype=torch.bfloat16,
                               device="meta")
            mla_decode_attention(q, pool, tables, kv_lens, 0.1, 512)
        else:
            q = torch.zeros((2, 64, 128), dtype=torch.bfloat16,
                            device="meta")
            w = torch.zeros((2, 64), device="meta")
            pool = torch.zeros((9, 1, BS, 128), dtype=torch.bfloat16,
                               device="meta")
            dsa_scores(q, w, pool, tables, kv_lens)


@pytest.mark.parametrize("kernel", ["mla_decode", "dsa_score"])
def test_decode_wrappers_refuse_other_widths(kernel):
    """Widths the kernels are not built for raise NotImplementedError on
    any non-CPU device, before the device check."""
    tables = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    kv_lens = torch.ones((2,), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        if kernel == "mla_decode":
            q = torch.zeros((2, 16, 320), dtype=torch.bfloat16,
                            device="meta")
            pool = torch.zeros((9, 1, 16, 320), dtype=torch.bfloat16,
                               device="meta")
            mla_decode_attention(q, pool, tables, kv_lens, 0.1, 256)
        else:
            q = torch.zeros((2, 32, 128), dtype=torch.bfloat16,
                            device="meta")
            w = torch.zeros((2, 32), device="meta")
            pool = torch.zeros((9, 1, 16, 128), dtype=torch.bfloat16,
                               device="meta")
            dsa_scores(q, w, pool, tables, kv_lens)

"""Shape logic of the W4A16 GEMV K2 and the paged-decode kernel K4/K6 in the
port, checked without a card: K2's launch plan (`gemv_plan`: column tile
and K slices by its fitted rule, `gemv_choices`), the decode plan
(`decode_plan`: splits from the table width, the window and B x Hkv), and
both wrappers' refusal, on any device but the CPU, of the shapes their
kernels do not take."""

import pytest
import torch

from tensorrt_llm_tpu_torch.ops import paged_attention as PA
from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W
from tensorrt_llm_tpu_torch.utils import cdiv

# (K, N, G, BN) of the served tiled projections: TinyLlama qkv / gate_up /
# down, Llama-3-8B down, GPT-OSS-20B qkv, Llama-2-7B's three
# (`choose_block_n`'s tiles)
SERVED_GEMV = [
    (2048, 2560, 128, 512),
    (2048, 11264, 128, 1024),
    (5632, 2048, 128, 1024),
    (14336, 4096, 128, 1024),
    (2880, 5120, 64, 1024),
    (4096, 12288, 128, 1024),   # Llama-2-7B qkv / gate_up / down
    (4096, 22016, 128, 512),
    (11008, 4096, 128, 1024),
]


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("K,N,G,bn", SERVED_GEMV)
@pytest.mark.parametrize("M", [1, 4, 16])
def test_gemv_plan_takes_its_rule(K, N, G, bn, M):
    """The plan takes a choice K2 can run (a column tile dividing BN, whole
    scale groups a slice, x's slice within its shared-memory room): the
    widest column tile, and the slice count its cost model puts least."""
    plan = W.gemv_plan(M, K, N, G, bn)
    choice = (plan["ctw"], plan["slices"])
    choices = W.gemv_choices(M, K, G, bn)
    assert choice in choices
    assert plan["ctw"] == max(c for c, _ in choices)
    assert bn % plan["cols"] == 0 and plan["cols"] == 64 * plan["ctw"]
    assert plan["grid"] == (N // plan["cols"], plan["slices"])
    mt = 8 if M <= 8 else 16
    assert mt * (cdiv(K // G, plan["slices"]) * G + 8) * 2 \
        <= W._GEMV_X_BYTES
    cost = W.gemv_cost_us(M, K, N, G, plan["ctw"], plan["slices"])
    assert all(W.gemv_cost_us(M, K, N, G, c, d) >= cost
               for c, d in choices if c == plan["ctw"])


@pytest.mark.parametrize("M,K,N,G,bn,want", [
    (4, 2048, 2560, 128, 512, (4, 16)),     # TinyLlama qkv: 10 x 16 blocks
    (4, 2048, 11264, 128, 1024, (4, 8)),    # TinyLlama gate_up: 44 x 8
    (4, 4096, 6144, 128, 1024, (4, 16)),    # Llama-3-8B qkv: 24 x 16
    (4, 4096, 28672, 128, 1024, (4, 8)),    # Llama-3-8B gate_up: 112 x 8
    (4, 4096, 12288, 128, 1024, (4, 8)),    # Llama-2-7B qkv: 48 x 8
    (16, 4096, 12288, 128, 1024, (4, 4)),   # 16 rows: 3 blocks an SM
    (4, 4096, 22016, 128, 512, (4, 4)),     # Llama-2-7B gate_up: 86 x 4
    (4, 11008, 4096, 128, 1024, (4, 16)),   # Llama-2-7B down: 16 x 16
    (16, 14336, 4096, 128, 1024, (4, 16)),  # x's room needs 11+ slices
    (4, 2880, 5120, 64, 1024, (4, 16)),     # GPT-OSS qkv: 20 x 16
])
def test_gemv_plan_choice(M, K, N, G, bn, want):
    plan = W.gemv_plan(M, K, N, G, bn)
    assert (plan["ctw"], plan["slices"]) == want


@pytest.mark.parametrize("M,K,G,bn", [
    (4, 2880, 64, 1024),      # GPT-OSS qkv: 45 groups, uneven slices
    (16, 14336, 128, 1024),   # 16 rows halve the x room a slice
    (4, 96, 32, 64),          # a 64-column tile only
])
def test_gemv_choices_cover_whole_groups(M, K, G, bn):
    ng = K // G
    choices = W.gemv_choices(M, K, G, bn)
    assert choices
    for ctw, d in choices:
        assert ctw in W.GEMV_CTW and bn % (64 * ctw) == 0
        assert d in W.GEMV_SLICES and d <= ng
        # slices start at whole groups, uneven by at most one group
        starts = [s * ng // d for s in range(d + 1)]
        sizes = {b - a for a, b in zip(starts, starts[1:])}
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_gemv_plan_overrides():
    plan = W.gemv_plan(4, 2048, 2560, 128, 512, ctw=2, slices=4)
    assert (plan["ctw"], plan["slices"], plan["grid"]) == (2, 4, (20, 4))
    with pytest.raises(ValueError):
        W.gemv_plan(4, 2048, 2560, 128, 128, ctw=4, slices=1)   # BN 128
    with pytest.raises(ValueError):
        W.gemv_plan(4, 2048, 2560, 128, 512, ctw=1, slices=3)   # a cluster
    with pytest.raises(ValueError):
        W.gemv_plan(4, 256, 2560, 128, 512, ctw=1, slices=4)    # 2 groups


@pytest.mark.parametrize("M,K,G,bn,exc", [
    (17, 2048, 128, 512, ValueError),            # past the GEMV's rows
    (4, 2080, 32, 96, NotImplementedError),      # BN % 64
    (4, 2064, 48, 128, NotImplementedError),     # G % 32
    (4, 2056, 8, 128, NotImplementedError),      # K % 32, G % 32
])
def test_gemv_plan_refuses(M, K, G, bn, exc):
    with pytest.raises(exc):
        W.gemv_plan(M, K, 4 * bn, G, bn)


@pytest.mark.parametrize("K,G,bn,exc", [
    (256, 128, 128, ValueError),             # K2 takes it: the device
    (96, 32, 64, ValueError),                # K % 64 == 32, G 32: taken
    (80, 80, 128, NotImplementedError),      # K % 32
    (128, 16, 128, NotImplementedError),     # G % 32
    (128, 64, 96, NotImplementedError),      # BN % 64
])
def test_gemv_wrapper_refuses_instead_of_falling_back(K, G, bn, exc):
    """Only a CPU tensor takes the plain version: K2's wrapper on any other
    device raises on a shape K2 does not take, then on a device that is not
    CUDA."""
    with pytest.raises(exc):
        W.w4a16_gemv(_meta((4, K), torch.bfloat16),
                      _meta((2, K // 2, bn), torch.int8),
                      _meta((K // G, 2 * bn), torch.bfloat16))


@pytest.mark.parametrize("B,Hkv,tokens,window,want", [
    (4, 4, 1024, None, (1, 1024)),   # 16 tiles: unsplit
    (4, 4, 1088, None, (3, 512)),    # 17 tiles: two tiles a warp
    (1, 8, 64, None, (1, 64)),       # short table: one split
    (4, 8, 672, None, (1, 1024)),    # GPT-OSS without a window
    (64, 8, 4096, None, (1, 4096)),  # enough (sequence, head) blocks
    (4, 8, 4000, None, (8, 512)),    # Llama-3-8B rows: one wave of blocks
    (8, 4, 2000, None, (4, 512)),
    (4, 8, 672, 128, (1, 1024)),     # GPT-OSS window 128: unsplit
    (2, 8, 320, 96, (1, 512)),       # a window past the table: one split
    # long tables: a window past the table splits as none does (Qwen2.5's
    # 131,072); a window of 4,096 counts the 9 splits it can touch, and
    # over a wave's blocks (EXAONE-4's 4 x 8 pairs) still takes the
    # shortest split; with enough (sequence, head) blocks it runs unsplit
    (4, 4, 4096, 131072, (8, 512)),
    (4, 4, 4096, None, (8, 512)),
    (4, 4, 5024, 4096, (10, 512)),
    (4, 8, 5008, 4096, (10, 512)),
    (4, 32, 4000, None, (2, 2048)),  # Llama-2-7B's 4 x 32 pairs
    (64, 8, 5024, 4096, (1, 8192)),
])
def test_decode_plan(B, Hkv, tokens, window, want):
    plan = PA.decode_plan(B, Hkv, tokens, window)
    assert (plan["n_splits"], plan["split_len"]) == want
    assert plan["split_len"] % PA.DECODE_TILE == 0
    assert plan["n_splits"] * plan["split_len"] >= tokens
    assert plan["split_len"] in PA.decode_split_choices(tokens)
    assert plan["grid_x"] == PA.split_grid(tokens, plan["split_len"], window)


@pytest.mark.parametrize("tokens,want", [
    (64, (64,)), (65, (64, 128)), (672, (64, 128, 256, 512, 1024))])
def test_decode_split_choices(tokens, want):
    assert PA.decode_split_choices(tokens) == want


NI = NotImplementedError


@pytest.mark.parametrize("D,G,BS,exc_bf16,exc_int8", [
    (128, 4, 16, ValueError, ValueError),   # the kernel takes it: the device
    (64, 8, 8, ValueError, ValueError),
    (64, 8, 4, NI, ValueError),             # bf16 pages: a multiple of 8
    (96, 4, 16, NI, NI),                    # head dim
    (64, 3, 16, ValueError, ValueError),    # any group up to 16
    (64, 16, 16, ValueError, ValueError),
    (256, 2, 16, ValueError, ValueError),   # Gemma's head dim
    (64, 17, 16, NI, NI),                   # 17 query heads a KV head
    (32, 4, 16, NI, NI),                    # head dim 32
    (64, 4, 6, NI, NI),                     # page of 6 tokens
])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_wrapper_refuses_instead_of_falling_back(
        D, G, BS, exc_bf16, exc_int8, int8):
    """Only a CPU tensor takes the plain version: on any other device the
    kernel's reach (head dim, group, page size) is checked first
    (NotImplementedError), then the device (ValueError)."""
    B, Hkv, NB, MB = 2, 2, 8, 4
    shape = (NB, Hkv, BS, D)
    pool = ((_meta(shape, torch.int8), _meta(shape[:3])) if int8
            else _meta(shape, torch.bfloat16))
    with pytest.raises(exc_int8 if int8 else exc_bf16):
        PA.paged_decode_attention(
            _meta((B, Hkv * G, D), torch.bfloat16), pool, pool,
            _meta((B, MB), torch.int32), _meta((B,), torch.int32), 0.1)


@pytest.mark.parametrize("tokens,L,window,want", [
    (4000, 256, None, 16),     # every split of the table
    (672, 64, 128, 3),         # a window of 128 touches at most 3 tiles
    (672, 256, 128, 2),
    (96, 64, 128, 2),          # never more than the table's splits
])
def test_split_grid(tokens, L, window, want):
    assert PA.split_grid(tokens, L, window) == want

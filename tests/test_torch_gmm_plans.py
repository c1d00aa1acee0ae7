"""Shape logic of the grouped expert GEMM K5 and the W4A8 GEMM K8 in the
port, checked without a card: K5's unit list (`gmm_units_plain`, the plain
counterpart of the prologue kernel that builds it on the device) against a
numpy enumeration, its plan (`gmm_plan`, `gmm_ntok`); K8's launch plan
(`w4a8_plan` given the token count, with K1's slice model); and both
wrappers' refusal, on any device but the CPU, of the shapes their kernels do not
take."""

import numpy as np
import pytest
import torch

from tensorrt_llm_tpu_torch.ops import moe_w4a16 as MW
from tensorrt_llm_tpu_torch.ops import w4a16_gemm as W

# (K, N, E, G) of the served expert products (GPT-OSS-20B, Moonlight-16B-A3B,
# DeepSeek-V3.2 and Qwen3-30B-A3B gate_up / down, MiniMax-M2 gate_up) and
# Mixtral-8x7B's, with the token counts each runs: 4 decode requests x
# top-k, and a prefill chunk x top-k
SERVED_MOE = [
    ((2880, 5760, 32, 64), (16, 32, 1024)),
    ((2880, 2880, 32, 64), (16, 32, 1024)),
    ((2048, 2816, 64, 128), (24, 1536)),
    ((1408, 2048, 64, 128), (24, 1536)),
    ((7168, 4096, 256, 128), (32, 2048)),
    ((2048, 7168, 256, 128), (32, 2048)),
    ((4096, 28672, 8, 128), (16, 32, 1024)),
    ((14336, 4096, 8, 128), (16, 32, 1024)),
    ((2048, 1536, 128, 128), (32, 2048)),
    ((768, 2048, 128, 128), (32, 2048)),
    ((3072, 3072, 256, 128), (32, 2048)),
]


def _routing(kind, M, E, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        ids = rng.integers(0, E, M)
    elif kind == "skewed":
        live = rng.permutation(E)[:max(1, E // 2)]
        p = 1.0 / np.arange(1, len(live) + 1)
        ids = rng.choice(live, M, p=p / p.sum())
    elif kind == "empty_experts":
        # every other expert empty, the first and last among them
        live = np.arange(1, E - 1, 2) if E > 2 else np.array([0])
        ids = rng.choice(live, M)
    else:                       # single expert
        ids = np.full(M, E // 2)
    return np.bincount(ids, minlength=E).astype(np.int32)


def _enumerate(sizes, M, ntok):
    """The unit list, written out: each expert's rows in tiles of ntok, in
    expert order."""
    units, start = [], 0
    for e, n in enumerate(sizes):
        for i in range(-(-int(n) // ntok)):
            units.append((e, start + i * ntok, min(ntok, int(n) - i * ntok)))
        start += int(n)
    bound = -(-M // ntok) + min(len(sizes), M)
    return units, bound


@pytest.mark.parametrize("ntok", MW.GMM_NTOK)
@pytest.mark.parametrize("kind", ["uniform", "skewed", "empty_experts",
                                  "single_expert"])
@pytest.mark.parametrize("M,E", [(16, 32), (24, 64), (32, 256), (200, 8),
                                 (1024, 32), (7, 3)])
def test_units_match_enumeration(M, E, kind, ntok):
    """Every row is covered once, in expert order, by units of at most
    ntok rows; the count stays within the static bound and the entries
    past it are zero."""
    sizes = _routing(kind, M, E, seed=M + E)
    want, bound = _enumerate(sizes, M, ntok)
    got = MW.gmm_units_plain(torch.from_numpy(sizes), M, ntok).numpy()
    assert got.dtype == np.int32 and got.shape == (bound + 1, 3)
    assert tuple(got[0]) == (len(want), ntok, bound)
    assert len(want) <= bound == MW.gmm_units_bound(M, E, ntok)
    np.testing.assert_array_equal(got[1:1 + len(want)],
                                  np.asarray(want).reshape(-1, 3))
    assert not got[1 + len(want):].any()
    rows = np.concatenate([np.arange(r, r + n) for _, r, n in want])
    np.testing.assert_array_equal(rows, np.arange(M))
    experts = [e for e, _, _ in want]
    assert experts == sorted(experts)


def test_units_follow_the_device_of_group_sizes():
    """The plain builder reads nothing back: it runs on a meta tensor."""
    gs = torch.zeros((8,), dtype=torch.int32, device="meta")
    assert MW.gmm_units_plain(gs, 40, 16).shape == (
        MW.gmm_units_bound(40, 8, 16) + 1, 3)


@pytest.mark.parametrize("shape,ms", SERVED_MOE)
def test_gmm_plan_served_shapes(shape, ms):
    K, N, E, G = shape
    for M in ms:
        p = MW.gmm_plan(M, E, K, N, G)
        assert p["ntok"] in MW.GMM_NTOK
        assert p["cols"] == 64 * p["nwg"] and p["nwg"] == (
            2 if p["ntok"] == 128 else 1)
        assert p["n_ct"] * p["cols"] >= N > (p["n_ct"] - 1) * p["cols"]
        assert p["bound"] == -(-M // p["ntok"]) + min(E, M)
        assert 0 < p["grid"] <= min(p["bound"] * p["n_ct"], 3 * 132)


@pytest.mark.parametrize("M,E", [(m, s[2]) for s, ms in SERVED_MOE
                                 for m in ms])
def test_gmm_ntok_depends_on_rows_and_experts_only(M, E):
    """One unit list serves gate_up and down: the tile is the same for
    every (K, N, G)."""
    tiles = {MW.gmm_plan(M, E, K, N, G)["ntok"]
             for (K, N, _, G), _ in SERVED_MOE}
    assert tiles == {MW.gmm_ntok(M, E)}


@pytest.mark.parametrize("M,E", [(16, 32), (32, 32), (24, 64), (32, 256),
                                 (16, 8), (32, 128)])
def test_gmm_ntok_decode_takes_a_small_tile(M, E):
    """At decode an expert gets 1-3 rows: a tile of 8 or 16 tokens (16
    where skewed routing gives an expert more than 8)."""
    assert MW.gmm_ntok(M, E) in (8, 16)


@pytest.mark.parametrize("M,E,want", [(1024, 32, 64), (1536, 64, 64),
                                      (2048, 256, 32), (1024, 8, 128),
                                      (2048, 128, 32)])
def test_gmm_ntok_prefill_grows_with_rows_per_expert(M, E, want):
    """At a prefill chunk the tile follows the rows an expert gets (32 to
    128 at GPT-OSS, Moonlight, V3.2, Qwen3-30B-A3B and Mixtral chunks)."""
    assert MW.gmm_ntok(M, E) == want


@pytest.mark.parametrize("K,N,G", [(2880, 5760, 48), (2880, 5760, 16),
                                   (2900, 5760, 100), (2880, 5700, 64),
                                   (80, 128, 80)])
def test_gmm_plan_refuses_what_k5_does_not_take(K, N, G):
    with pytest.raises(NotImplementedError):
        MW.gmm_plan(16, 32, K, N, G)


# (K, N, block_n) of Llama-3-8B's W4A8 projections (tiled), and K-paired
# weights as stored: N 80 (no 64-column tile) and GPT-OSS o_proj's 2880
W4A8_SHAPES = [(4096, 6144, 1024, 32), (4096, 4096, 1024, 32),
               (4096, 28672, 1024, 32), (14336, 4096, 1024, 112),
               (4096, 80, 0, 32), (4096, 2880, 0, 1)]


@pytest.mark.parametrize("M", (1, 4, 16, 17, 128, 200, 255, 256, 512))
@pytest.mark.parametrize("K,N,bn,n_groups", W4A8_SHAPES)
def test_w4a8_plan_covers_the_launch(K, N, bn, n_groups, M):
    """Given M, the plan keeps the route's keys and adds the launch: token
    and column tiles cover M and N, the K slices cover K's 64-row stages
    in K order, uneven by at most one stage, and the grid fits the slots."""
    route = W.w4a8_plan(K, N, n_groups, bn)
    p = W.w4a8_plan(K, N, n_groups, bn, M)
    assert {k: p[k] for k in route} == route
    assert (p["ntok"], p["nwg"]) == W.sm90_tiles(M)
    assert p["n_mb"] * p["ntok"] >= M > (p["n_mb"] - 1) * p["ntok"]
    assert p["n_ct"] * p["cols"] >= N > (p["n_ct"] - 1) * p["cols"]
    starts = np.asarray(p["stage_start"])
    assert starts[0] == 0 and starts[-1] == K // 64
    sizes = np.diff(starts)
    assert (sizes > 0).all() and sizes.max() - sizes.min() <= 1
    assert len(sizes) == p["slices"] == W.k1_choice(M, K, N, 132,
                                                    W.K8_K1_VARIANT)[1]
    assert p["units"] == p["n_mb"] * p["n_ct"] * p["slices"]
    assert 0 < p["grid"] <= min(p["units"], p["slots"])


@pytest.mark.parametrize("K,N,bn,n_groups", W4A8_SHAPES[3:5])
def test_w4a8_plan_slices_k_where_columns_leave_sms_idle(K, N, bn,
                                                         n_groups):
    """At decode Llama-3-8B down has 64 column tiles and N 80 two: the plan
    cuts K so that the units fill more of the card."""
    p = W.w4a8_plan(K, N, n_groups, bn, 4)
    assert p["slices"] > 1 and p["units"] > p["n_ct"]


def test_w4a8_plan_slices_override_and_range():
    assert W.w4a8_plan(4096, 4096, 32, 1024, 4, slices=3)["slices"] == 3
    for bad in (0, 65, W.K1_MAX_SLICES + 1):
        with pytest.raises(ValueError):
            W.w4a8_plan(4096, 4096, 32, 1024, 4, slices=bad)


@pytest.mark.parametrize("K,N,n_groups,bn", [
    (4096, 72, 32, 0),        # K-paired N % 16
    (4096, 4096, 128, 1024),  # G 32
    (4096, 4096, 32, 96),     # tile not a multiple of 64
    (4000, 4096, 1, 1024),    # K % 64
])
def test_w4a8_plan_refuses_with_any_token_count(K, N, n_groups, bn):
    for M in (None, 4, 256):
        with pytest.raises(NotImplementedError):
            W.w4a8_plan(K, N, n_groups, bn, M)


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("K,G,bn,exc", [
    (128, 64, 128, ValueError),              # K5 takes it: the device
    (96, 32, 64, ValueError),                # K % 64 == 32, G 32: taken
    (80, 80, 128, NotImplementedError),      # K % 32
    (128, 16, 128, NotImplementedError),     # G % 32
    (128, 64, 96, NotImplementedError),      # BN % 64
])
def test_grouped_wrapper_refuses_instead_of_falling_back(K, G, bn, exc):
    """Only a CPU tensor takes the plain version: any other device goes to
    K5's wrapper, which raises on a shape K5 does not take and then on a
    device that is not CUDA."""
    E, M = 4, 10
    gs = torch.tensor([3, 0, 5, 2], dtype=torch.int32)
    with pytest.raises(exc):
        MW.w4a16_grouped_matmul(
            _meta((M, K), torch.bfloat16),
            _meta((E, 2, K // 2, bn), torch.int8), _meta((E, K // G, 2 * bn)),
            gs.to("meta"), MW.gmm_work_units(gs, M).to("meta"))


@pytest.mark.parametrize("K,N,G,kpaired,exc", [
    (256, 128, 128, False, ValueError),          # K8 takes it: the device
    (256, 80, 128, True, ValueError),
    (256, 72, 128, True, NotImplementedError),   # N % 16
    (256, 128, 32, False, NotImplementedError),  # G % 64
    (224, 128, 32, True, NotImplementedError),   # K % 64
])
def test_w4a8_wrapper_refuses_instead_of_falling_back(K, N, G, kpaired, exc):
    packed = (_meta((K // 2, N), torch.int8) if kpaired
              else _meta((1, K // 2, N), torch.int8))
    with pytest.raises(exc):
        W.w4a8_matmul(_meta((4, K), torch.bfloat16), packed,
                      _meta((K // G, N)), _meta((K // G, N)))

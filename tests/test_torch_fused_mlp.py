"""Port parity: the one-launch W4A16 gated MLP (`ops/w4a16_fused.py`).

The same numpy inputs and weights go through the port's
`w4a16_fused_mlp` (CPU tensors take `w4a16_fused_mlp_plain`, the
arithmetic kernel K14 is held to on the card) and the JAX package's
`w4a16_fused_mlp(..., interpret=True)`, which runs its Pallas
`_fused_mlp_kernel` on the CPU.

Tolerance: both keep the gate and up accumulators in f32 and round
h = act(g) * u once to bf16, then reduce h @ down in f32.  They differ in
where the group scale multiplies (the kernel scales per-group f32
partials, the plain version multiplies by the exact f32 weight), so single
elements of h can round one bf16 ulp apart (2^-8 relative): 1e-2 of
max|ref| bounds that with margin.  Against the unfused `GatedMLP` (which
rounds gate_up to bf16 before the activation) the gap is of the same kind
and is held to 2e-2 of max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops import w4a16_fused as jf
from tensorrt_llm_tpu.quantization import quantize as jq
from tensorrt_llm_tpu_torch.layers.mlp import GatedMLP
from tensorrt_llm_tpu_torch.ops import w4a16_fused as F
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

K, I, G = 256, 512, 128
BN, BND = 256, 256


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _weights(seed, zeros, biases):
    """gate|up fused [K, 2I] and down [I, K], quantized and tiled as the
    JAX package's GatedMLP stores them at tp = 1."""
    rng = np.random.default_rng(seed)
    wgu = rng.standard_normal((K, 2 * I), dtype=np.float32) * 0.05
    wd = rng.standard_normal((I, K), dtype=np.float32) * 0.05
    qg, sg, zg = jq.quantize_w4(jnp.asarray(wgu), G, not zeros)
    qd, sd, zd = jq.quantize_w4(jnp.asarray(wd), G, not zeros)
    out = [np.asarray(jq.pack_w4_tiled(qg, BN)), np.asarray(sg),
           np.asarray(jq.pack_w4_tiled(qd, BND)), np.asarray(sd),
           None if zg is None else np.asarray(zg),
           None if zd is None else np.asarray(zd)]
    out += ([rng.standard_normal((2 * I,), dtype=np.float32) * 0.1,
             rng.standard_normal((K,), dtype=np.float32) * 0.1]
            if biases else [None, None])
    return out, (wgu, wd)


def _x(M, seed):
    x = np.random.default_rng(seed).standard_normal((M, K), dtype=np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("biases", [False, True])
def test_plain_matches_jax_fused_kernel(act, zeros, biases):
    ws, _ = _weights(1 + zeros + 2 * biases, zeros, biases)
    x = _x(5, 7)
    ref = np.asarray(jf.w4a16_fused_mlp(
        jnp.asarray(x), *[None if a is None else jnp.asarray(a) for a in ws],
        activation=act, out_dtype=jnp.float32, interpret=True), np.float32)
    out = F.w4a16_fused_mlp(_t(x), *[_t(a) for a in ws], activation=act,
                            out_dtype=torch.float32).numpy()
    assert out.shape == (5, K)
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


def test_plain_close_to_unfused_gated_mlp():
    """The fused arithmetic against the port's two-linear `GatedMLP` on
    the same float weights (gate_up rounded to bf16 there)."""
    ws, (wgu, wd) = _weights(4, False, False)
    mlp = GatedMLP(K, I, "silu", QuantConfig(quant_algo=QuantAlgo.W4A16,
                                             group_size=G))
    mlp.from_float(torch.from_numpy(wgu[:, :I]), torch.from_numpy(wgu[:, I:]),
                   torch.from_numpy(wd))
    x = torch.from_numpy(_x(9, 3)).to(torch.bfloat16)
    fused = F.w4a16_fused_mlp(x, mlp.gate_up.qweight, mlp.gate_up.scales,
                              mlp.down.qweight, mlp.down.scales,
                              activation="silu").float()
    ref = mlp(x).float()
    assert (fused - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_leading_dims_and_out_dtype():
    ws, _ = _weights(5, True, True)
    x = _t(_x(6, 11))
    flat = F.w4a16_fused_mlp(x, *[_t(a) for a in ws])
    lead = F.w4a16_fused_mlp(x.reshape(2, 3, K), *[_t(a) for a in ws])
    assert lead.shape == (2, 3, K) and lead.dtype == x.dtype
    torch.testing.assert_close(lead.reshape(6, K), flat, rtol=0, atol=0)


@pytest.mark.parametrize("Kx,Ix,bn,bnd,group,act", [
    (2048, 5600, 128, 128, 128, "silu"),    # I not a multiple of 64
    (2048, 5632, 128, 128, 128, "swish"),   # unknown activation
    (2048, 5632, 128, 128, 48, "silu"),     # group not a multiple of 32
    (2048, 5632, 96, 128, 32, "silu"),      # tile width not a multiple of 64
])
def test_supported_refuses_what_the_kernel_does_not_take(Kx, Ix, bn, bnd,
                                                         group, act):
    assert not F.fused_mlp_supported(Kx, Ix, bn, bnd, group, act)
    # the JAX check ends in `or True`: an intended difference (ROADMAP)
    assert jf.fused_mlp_supported(Kx, Ix, bn, bnd, group, act)


def test_supported_accepts_the_served_mlps():
    assert F.fused_mlp_supported(2048, 5632, 1024, 1024, 128, "silu")
    assert F.fused_mlp_supported(4096, 14336, 1024, 1024, 128, "gelu")


# K14's plan (`fused_mlp_plan`): the served MLPs and this module's width
PLAN_WIDTHS = [(2048, 5632), (4096, 14336), (K, I)]
PLAN_M = (1, 4, 16, 64, 200, 256)


def _bound(ctw, ntt, cluster, smem):
    """A co-resident bound given to the plan: 7 groups of 36 block slots
    (18 SMs x 2), as `cudaOccupancyMaxActiveClusters` would answer."""
    return 7 * (36 // cluster) if smem <= 113 * 1024 else 7 * (18 // cluster)


@pytest.mark.parametrize("Kx,Ix", PLAN_WIDTHS)
@pytest.mark.parametrize("M", PLAN_M)
def test_plan_slices_cover_whole_groups(M, Kx, Ix):
    """Every candidate's phase-A slices cover K and phase B's cover I
    exactly, in whole scale groups; the cluster is at most 16 blocks and
    the grid within the co-resident bound the plan is given."""
    choices = F.fused_mlp_plan_choices(M, Kx, Ix, G, G, coresident=_bound)
    assert choices
    pick = F.fused_mlp_plan(M, Kx, Ix, G, G, coresident=_bound)
    assert pick["key"] in {c["key"] for c in choices}
    for p in choices:
        for bounds, width in ((p["a_bounds"], Kx), (p["b_bounds"], Ix)):
            assert bounds[0] == 0 and bounds[-1] == width
            assert all(b % G == 0 for b in bounds)
            assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
        assert len(p["a_bounds"]) == p["sa"] + 1
        assert len(p["b_bounds"]) == p["sb"] + 1
        assert 1 <= p["cluster"] <= 16
        assert p["cluster"] % p["sa"] == 0 and p["cluster"] % p["sb"] == 0
        assert 1 <= p["clusters"] <= _bound(p["ctw"], p["ntt"], p["cluster"],
                                            p["smem"])
        assert p["grid"] == p["clusters"] * p["cluster"]
        assert p["smem"] <= F.FUSED_MAX_SMEM
        assert p["ntt"] in F.fused_mlp_ntts(M)
        assert p["mt"] == 8 * p["ntt"]
        assert p["n_mb"] * p["mt"] >= M > (p["n_mb"] - 1) * p["mt"]
        lanes_a = p["clusters"] * (p["cluster"] // p["sa"])
        lanes_b = p["clusters"] * (p["cluster"] // p["sb"])
        assert p["rounds_a"] * lanes_a >= p["items_a"]
        assert p["rounds_b"] * lanes_b >= p["items_b"]


@pytest.mark.parametrize("Kx,Ix", PLAN_WIDTHS[:2])
def test_plan_splits_phase_a_over_k_at_decode(Kx, Ix):
    """At a 4-token decode both served MLPs launch more phase-A work items
    (column pairs x K slices) than there are 64-column pairs."""
    p = F.fused_mlp_plan(4, Kx, Ix, G, G, coresident=_bound)
    assert p["sa"] > 1 and p["items_a"] * p["sa"] > Ix // 64


def test_plan_per_channel_and_n_k2():
    """A per-channel scale still splits K (one scale row read for every
    128 rows); `n_k2` fixes phase B's slices."""
    p = F.fused_mlp_plan(4, 2048, 5632, 2048, 5632, coresident=_bound)
    assert p["GA"] == 128 and p["GB"] == 128
    q = F.fused_mlp_plan(4, 2048, 5632, G, G, coresident=_bound, n_k2=2)
    assert q["sb"] == 2
    with pytest.raises(ValueError):
        F.fused_mlp_plan(4, 2048, 5632, G, G, coresident=_bound, n_k2=3)


def _units_case(M, zeros, biases, seed):
    ws, _ = _weights(seed, zeros, biases)
    return _t(_x(M, seed + 5)), [_t(a) for a in ws]


@pytest.mark.parametrize("zeros,biases", [(False, False), (True, True)])
@pytest.mark.parametrize("M", [1, 5, 40])
def test_units_walk_matches_plain(M, zeros, biases):
    """The plain walk of every candidate's decomposition (slices summed in
    slice order, each group's partial times its scale) against the plain
    version: within the module's 1e-2 of max|ref|."""
    x, ws = _units_case(M, zeros, biases, 11 + M)
    ref = F.w4a16_fused_mlp_plain(x, *ws, activation="silu",
                                  out_dtype=torch.float32)
    choices = F.fused_mlp_plan_choices(M, K, I, G, G, coresident=_bound,
                                       zeros=zeros)
    assert len(choices) > 1
    for p in choices:
        out = F.fused_mlp_units_plain(x, *ws, activation="silu", plan=p,
                                      out_dtype=torch.float32)
        assert out.shape == (M, K)
        assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


def test_units_walk_per_channel_scales():
    """Per-channel scales (one row) read once for every 128-row unit."""
    rng = np.random.default_rng(21)
    wgu = jnp.asarray(rng.standard_normal((K, 2 * I), dtype=np.float32) * .05)
    wd = jnp.asarray(rng.standard_normal((I, K), dtype=np.float32) * .05)
    qg, sg, _ = jq.quantize_w4(wgu, K, True)
    qd, sd, _ = jq.quantize_w4(wd, I, True)
    ws = [_t(jq.pack_w4_tiled(qg, BN)), _t(sg), _t(jq.pack_w4_tiled(qd, BND)),
          _t(sd)]
    x = _t(_x(3, 4))
    ref = F.w4a16_fused_mlp_plain(x, *ws, out_dtype=torch.float32)
    p = F.fused_mlp_plan(3, K, I, K, I, coresident=_bound)
    out = F.fused_mlp_units_plain(x, *ws, plan=p, out_dtype=torch.float32)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


META_REFUSED = [
    # (K, I, BN, group, what the wrapper raises on a non-CPU tensor)
    (K, I, BN, G, ValueError),                    # the device
    (K, I, 32, G, NotImplementedError),           # tile not a 64-multiple
    (K, I, BN, 16, NotImplementedError),          # group not a 32-multiple
]


@pytest.mark.parametrize("Kx,Ix,bn,group,exc", META_REFUSED)
def test_wrapper_refuses_instead_of_falling_back(Kx, Ix, bn, group, exc):
    """Only a CPU tensor takes the plain version: a tensor on any other
    device goes to the kernel path, which raises NotImplementedError on
    shapes K14 does not take before it checks the device."""
    def meta(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device="meta")
    x = meta((4, Kx), torch.bfloat16)
    gu = meta((2 * Ix // bn, Kx // 2, bn), torch.int8)
    gs = meta((Kx // group, 2 * Ix), torch.bfloat16)
    dn = meta((Kx // bn, Ix // 2, bn), torch.int8)
    ds = meta((Ix // group, Kx), torch.bfloat16)
    with pytest.raises(exc):
        F.w4a16_fused_mlp(x, gu, gs, dn, ds)


def test_smem_mirror_counts_the_zero_rows():
    """`fused_mlp_smem` (the kernel's layout) grows with zero points and
    with the slices' width."""
    base = F.fused_mlp_smem(1, 1, 2048, 5632, G, G, 8, 8, False)
    assert F.fused_mlp_smem(1, 1, 2048, 5632, G, G, 8, 8, True) > base
    assert F.fused_mlp_smem(1, 1, 2048, 5632, G, G, 4, 4, False) > base
    assert base % 16 == 0

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


@pytest.mark.parametrize("M,Kx,Ix,want", [
    (4, 2048, 5632, 11),     # TinyLlama decode: 32 down tiles x 11 slices
    (200, 2048, 5632, 4),    # 4 M tiles x 32 tiles x 4 slices
    (4, 4096, 14336, 7),     # Llama-3-8B decode: 64 tiles x 7 slices
])
def test_down_phase_slices(M, Kx, Ix, want):
    n_k2 = F.fused_mlp_n_k2(M, Kx, Ix, 128)
    assert n_k2 == want
    assert Ix % n_k2 == 0 and (Ix // n_k2) % 128 == 0

"""Port parity for Multi-head Latent Attention against the JAX package.

Small widths (H = 4 heads, latent L = 64 + rope R = 16, pages of 8), inputs
drawn with numpy from a seed and fed to both sides.

* Interleaved RoPE: the same f32 formula on f32 inputs: atol 1e-6.
* `write_latent_cache`: the same rows land in the same slots, bit for bit,
  in the first L + R channels of the JAX pool.
* `mla_decode_plain` / `mla_prefill_plain`: against the XLA references
  (the same f32 math; the bf16 outputs may differ by one rounding step,
  2^-8 of the largest output) and against the Pallas kernels in interpret
  mode (which round q * scale (decode) and P to bf16: 2e-2, the JAX
  package's own tolerance for them).
* The `MLA` module with both Q paths (direct `q_proj`, and q_a -> norm ->
  q_b), W4A16 group 64, from the same float weights, through a chunked
  prefill and a decode step: 0.03 absolute on outputs of magnitude ~1
  (bf16 activations through five linears; f32 sums in another order move
  a bf16 value by an ulp here and there).  The module test uses L = 48
  (L + R = 64 columns of `kv_a`); any width a multiple of 16 would do on
  the card too, where a K-paired `kv_a` runs kernel K12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.attention_backend.interface import (
    AttentionMetadata as JMeta)
from tensorrt_llm_tpu.layers.mla import MLA as JMLA
from tensorrt_llm_tpu.ops.mla import mla_decode_xla, mla_prefill_xla
from tensorrt_llm_tpu.ops.mla import write_latent_cache as jax_write_latent
from tensorrt_llm_tpu.ops.mla_pallas import (
    mla_decode_pallas, mla_prefill_pallas)
from tensorrt_llm_tpu.ops.rope import RopeConfig as JRope
from tensorrt_llm_tpu.ops.rope import apply_rope as jax_apply_rope
from tensorrt_llm_tpu.quantization import QuantAlgo as JQA
from tensorrt_llm_tpu.quantization import QuantConfig as JQC
from tensorrt_llm_tpu_torch.attention_backend import AttentionMetadata
from tensorrt_llm_tpu_torch.layers.mla import MLA
from tensorrt_llm_tpu_torch.ops.mla import (
    mla_decode_attention, mla_decode_plain, mla_prefill_attention,
    mla_prefill_plain, write_latent_cache)
from tensorrt_llm_tpu_torch.ops.rope import RopeConfig, apply_rope
from tensorrt_llm_tpu_torch.ops.rope import make_rope_tables
from tensorrt_llm_tpu_torch.quantization import QuantAlgo, QuantConfig

H, L, R, BS = 4, 64, 16, 8


def _bf16(a):
    """numpy f32 values exactly representable in bf16."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _paged(rng, lens, dk=L + R):
    """A bf16-exact latent pool [NB, 1, BS, dk] and shuffled tables."""
    mb = max(-(-n // BS) for n in lens)
    nb = len(lens) * mb + 1
    pool = _bf16(rng.standard_normal((nb, 1, BS, dk)))
    tables = (rng.permutation(nb - 1)[:len(lens) * mb].reshape(len(lens), mb)
              + 1).astype(np.int32)
    return pool, tables


@pytest.mark.parametrize("interleaved", [True, False])
def test_rope_matches_jax(interleaved):
    rng = np.random.default_rng(0)
    cos, sin = make_rope_tables(RopeConfig(head_dim=R, theta=10000.0,
                                           max_position=64))
    q = rng.standard_normal((5, H, R)).astype(np.float32)
    k = rng.standard_normal((5, 1, R)).astype(np.float32)
    pos = np.array([0, 3, 7, 31, 63])
    jq, jk = jax_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                            jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
                            interleaved=interleaved)
    tq, tk = apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(pos), cos, sin,
                        interleaved=interleaved)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-6)


def test_write_latent_cache_matches_jax():
    rng = np.random.default_rng(1)
    NB, T = 6, 11
    lat = _bf16(rng.standard_normal((T, L + R)))
    slots = rng.permutation(np.arange(BS, NB * BS))[:T].astype(np.int32)
    jpool = jax_write_latent(jnp.zeros((NB, 1, BS, 128), jnp.bfloat16),
                             jnp.pad(jnp.asarray(lat, jnp.bfloat16),
                                     ((0, 0), (0, 128 - L - R))),
                             jnp.asarray(slots))
    tpool = torch.zeros((NB, 1, BS, L + R), dtype=torch.bfloat16)
    write_latent_cache(tpool, _t(lat), torch.from_numpy(slots))
    jnp_pool = np.asarray(jpool.astype(jnp.float32))
    np.testing.assert_array_equal(tpool.float().numpy(),
                                  jnp_pool[..., :L + R])
    assert not jnp_pool[..., L + R:].any()


@pytest.mark.parametrize("lens", [[5, 17, 40], [1, 64]])
def test_mla_decode_plain_matches_jax(lens):
    rng = np.random.default_rng(len(lens))
    pool, tables = _paged(rng, lens)
    B = len(lens)
    q = _bf16(rng.standard_normal((B, H, L + R)))
    kv = np.asarray(lens, np.int32)
    scale = (32 + R) ** -0.5
    out = mla_decode_plain(_t(q), _t(pool), torch.from_numpy(tables),
                           torch.from_numpy(kv), scale, L).float().numpy()
    args = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16),
            jnp.asarray(tables), jnp.asarray(kv), scale, L)
    ref = np.asarray(mla_decode_xla(*args), np.float32)
    top = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -8 * top)
    pal = np.asarray(mla_decode_pallas(*args, tile_size=2 * BS,
                                       interpret=True), np.float32)
    np.testing.assert_allclose(out, pal, rtol=2e-2, atol=2e-2)
    # the wrapper takes the plain version for CPU tensors
    via = mla_decode_attention(_t(q), _t(pool), torch.from_numpy(tables),
                               torch.from_numpy(kv), scale, L)
    np.testing.assert_array_equal(via.float().numpy(), out)


@pytest.mark.parametrize("T,off", [(16, 0), (12, 20), (7, 9)])
def test_mla_prefill_plain_matches_jax(T, off):
    rng = np.random.default_rng(T + off)
    kv_len = off + T
    pool, tables = _paged(rng, [kv_len])
    q = _bf16(rng.standard_normal((T, H, L + R)))
    scale = (32 + R) ** -0.5
    out = mla_prefill_plain(_t(q), _t(pool), torch.from_numpy(tables[0]),
                            kv_len, off, scale, L).float().numpy()
    args = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16),
            jnp.asarray(tables[0]), jnp.int32(kv_len), jnp.int32(off), scale,
            L)
    ref = np.asarray(mla_prefill_xla(*args), np.float32)
    top = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -8 * top)
    pal = np.asarray(mla_prefill_pallas(*args, tile_size=2 * BS,
                                        interpret=True), np.float32)
    np.testing.assert_allclose(out, pal, rtol=2e-2, atol=2e-2)
    via = mla_prefill_attention(_t(q), _t(pool), torch.from_numpy(tables[0]),
                                kv_len, off, scale, L)
    np.testing.assert_array_equal(via.float().numpy(), out)


def test_mla_prefill_plain_matches_jax_at_kernel_widths():
    """The plain version K10 is held to on the card, at the kernel's own
    widths (L 512, R 64, 16 heads, pages of 16, a 17-token chunk after 37
    cached tokens), against the XLA reference and the Pallas kernel in
    interpret mode, with the tolerances above."""
    rng = np.random.default_rng(17)
    Lk, Rk, Hk, BSk, T, off = 512, 64, 16, 16, 17, 37
    kv_len = off + T
    mb = -(-kv_len // BSk)
    pool = _bf16(rng.standard_normal((mb + 2, 1, BSk, Lk + Rk)))
    table = (rng.permutation(mb + 1)[:mb] + 1).astype(np.int32)
    q = _bf16(rng.standard_normal((T, Hk, Lk + Rk)))
    scale = (128 + Rk) ** -0.5
    out = mla_prefill_plain(_t(q), _t(pool), torch.from_numpy(table), kv_len,
                            off, scale, Lk).float().numpy()
    args = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16),
            jnp.asarray(table), jnp.int32(kv_len), jnp.int32(off), scale, Lk)
    ref = np.asarray(mla_prefill_xla(*args), np.float32)
    top = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -8 * top)
    pal = np.asarray(mla_prefill_pallas(*args, tile_size=2 * BSk,
                                        interpret=True), np.float32)
    np.testing.assert_allclose(out, pal, rtol=2e-2, atol=2e-2)


def test_mla_decode_plain_matches_jax_at_kernel_widths():
    """The plain version K9 is held to on the card, at the kernel's own
    widths (L 512, R 64, 16 heads, pages of 16, short contexts of 1 to 40
    tokens), against the XLA reference and the Pallas kernel in interpret
    mode, with the tolerances above."""
    rng = np.random.default_rng(19)
    Lk, Rk, Hk, BSk = 512, 64, 16, 16
    lens = [1, 17, 40]
    mb = -(-max(lens) // BSk)
    nb = len(lens) * mb + 1
    pool = _bf16(rng.standard_normal((nb, 1, BSk, Lk + Rk)))
    tables = (rng.permutation(nb - 1)[:len(lens) * mb].reshape(len(lens), mb)
              + 1).astype(np.int32)
    q = _bf16(rng.standard_normal((len(lens), Hk, Lk + Rk)))
    kv = np.asarray(lens, np.int32)
    scale = (128 + Rk) ** -0.5
    out = mla_decode_plain(_t(q), _t(pool), torch.from_numpy(tables),
                           torch.from_numpy(kv), scale, Lk).float().numpy()
    args = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16),
            jnp.asarray(tables), jnp.asarray(kv), scale, Lk)
    ref = np.asarray(mla_decode_xla(*args), np.float32)
    top = max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -8 * top)
    pal = np.asarray(mla_decode_pallas(*args, tile_size=2 * BSk,
                                       interpret=True), np.float32)
    np.testing.assert_allclose(out, pal, rtol=2e-2, atol=2e-2)


def test_mla_prefill_extra_mask_matches_jax():
    rng = np.random.default_rng(9)
    T, off = 10, 6
    pool, tables = _paged(rng, [off + T])
    q = _bf16(rng.standard_normal((T, H, L + R)))
    S = tables.shape[1] * BS
    mask = rng.random((T, S)) < 0.6
    mask[:, 0] = True
    out = mla_prefill_plain(_t(q), _t(pool), torch.from_numpy(tables[0]),
                            off + T, off, 0.1, L,
                            extra_mask=torch.from_numpy(mask)).float().numpy()
    ref = np.asarray(mla_prefill_xla(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16),
        jnp.asarray(tables[0]), jnp.int32(off + T), jnp.int32(off), 0.1, L,
        extra_mask=jnp.asarray(mask)), np.float32)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2 ** -8 * max(1.0, np.abs(ref).max()))


def test_kernel_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses what it cannot launch."""
    q = torch.zeros((1, 16, 576), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mla_decode_attention(q.to("meta"), torch.zeros((2, 1, 16, 576)),
                             torch.zeros((1, 1), dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32), 0.1, 512)


HIDDEN, LM, NOPE, V, QLORA = 128, 48, 32, 32, 64


def _module_weights(rng, q_lora):
    f = lambda *s, std: (rng.standard_normal(s) * std).astype(np.float32)
    std = 0.5 / HIDDEN ** 0.5
    w = dict(kv_a_w=f(HIDDEN, LM + R, std=std),
             kv_b_w=f(LM, H * (NOPE + V), std=0.5 / LM ** 0.5),
             o_w=f(H * V, HIDDEN, std=std),
             kv_norm=1 + f(LM, std=0.1))
    if q_lora:
        w.update(q_a_w=f(HIDDEN, QLORA, std=std),
                 q_b_w=f(QLORA, H * (NOPE + R), std=0.5 / QLORA ** 0.5),
                 q_norm=1 + f(QLORA, std=0.1))
    else:
        w["q_w"] = f(HIDDEN, H * (NOPE + R), std=std)
    return w


@pytest.mark.parametrize("q_lora", [False, True], ids=["q_proj", "q_lora"])
def test_mla_module_matches_jax(q_lora):
    rng = np.random.default_rng(4)
    scale = (NOPE + R) ** -0.5
    group = 64
    jm = JMLA(hidden_size=HIDDEN, num_heads=H,
              q_lora_rank=QLORA if q_lora else None, kv_lora_rank=LM,
              qk_nope_head_dim=NOPE, qk_rope_head_dim=R, v_head_dim=V,
              rope=JRope(head_dim=R, interleaved=True), scale=scale,
              rms_eps=1e-6, quant=JQC(quant_algo=JQA.W4A16, group_size=group),
              backend="xla")
    tm = MLA(HIDDEN, H, QLORA if q_lora else None, LM, NOPE, R, V, scale,
             1e-6, interleaved=True,
             quant=QuantConfig(quant_algo=QuantAlgo.W4A16, group_size=group))
    w = _module_weights(rng, q_lora)
    params = jm.from_float(**{k: jnp.asarray(v) for k, v in w.items()})
    tm.from_float(**{k: torch.from_numpy(v) for k, v in w.items()})
    cos, sin = make_rope_tables(RopeConfig(head_dim=R, max_position=64))
    jtab = (jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
    NB = 6
    jpool = jnp.zeros((NB, 1, BS, LM + R), jnp.bfloat16)
    tpool = torch.zeros((NB, 1, BS, LM + R), dtype=torch.bfloat16)
    blocks = [3, 1, 4]
    seq = 21
    x_all = _bf16(rng.standard_normal((seq + 1, HIDDEN)))

    def step(mode, lo, hi, q_offset):
        pos = np.arange(lo, hi)
        slots = np.array([blocks[p // BS] * BS + p % BS for p in pos],
                         np.int32)
        tables = np.array([blocks], np.int32)
        kv = np.array([hi], np.int32)
        jmeta = JMeta(positions=jnp.asarray(pos, jnp.int32),
                      slot_mapping=jnp.asarray(slots),
                      block_tables=jnp.asarray(tables),
                      kv_lens=jnp.asarray(kv), q_offset=jnp.int32(q_offset),
                      mode=mode)
        nonlocal jpool
        jout, jpool = jm(params, jnp.asarray(x_all[lo:hi], jnp.bfloat16),
                         jtab, jpool, jmeta)
        tmeta = AttentionMetadata(
            positions=torch.from_numpy(pos), slot_mapping=torch.from_numpy(
                slots), block_tables=torch.from_numpy(tables),
            kv_lens=torch.from_numpy(kv), q_offset=q_offset, mode=mode)
        with torch.no_grad():
            tout = tm(_t(x_all[lo:hi]), (cos, sin), tpool, tmeta)
        ref = np.asarray(jout, np.float32)
        assert np.abs(tout.float().numpy() - ref).max() <= 0.03, \
            np.abs(tout.float().numpy() - ref).max()
        np.testing.assert_array_equal(
            tpool.float().numpy(),
            np.asarray(jpool.astype(jnp.float32)))

    step("prefill", 0, 13, 0)
    step("prefill", 13, seq, 13)
    step("decode", seq, seq + 1, 0)

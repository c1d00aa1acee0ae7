"""Weight quantization and int4 packing, bit-exact with the JAX package.

Counterpart of `tensorrt_llm_tpu/quantization/quantize.py`.  Both packings of
the JAX package are kept so that its quantized parameters load unchanged:

* K-paired (`pack_w4`, ``[K//2, N]``): within each chunk of `pack_group` rows,
  byte ``[c*Gp/2 + r, n]`` holds row ``c*Gp + r`` in its low nibble and row
  ``c*Gp + Gp/2 + r`` in its high nibble.
* Tiled (`pack_w4_tiled`, ``[N//BN, K//2, BN]``): byte ``[j, r, n]`` holds
  rows ``2r`` (low nibble) and ``2r + 1`` (high nibble) of column
  ``j*BN + n``.  Every output-column tile is one contiguous chunk; this is
  the layout the CUDA kernels read.

Values are signed int4 in two's complement.  Rounding is half-to-even on both
sides (`jnp.round` and `torch.round`), and every division is correctly
rounded (`div_scalar` on the card), so `quantize_w4` matches bit for bit,
on the CPU and on the card.

The 8-bit weights are per output channel (`quantize_w8`: int8 in [-128,
127] against absmax / 127, the JAX package's `quantize_w8`;
`quantize_fp8`: e4m3 against absmax / 448, its `FP8LinearMethod.
make_params`).  The cast to e4m3 rounds to nearest even and saturates at
+-448 (`to_e4m3` clamps first: what PyTorch's own cast does past 448
depends on its version, NaN on some), where the JAX package's cast gives
NaN past ~464; the weights never get there (|w| / scale <= 448).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensorrt_llm_tpu_torch.utils import div_scalar

# Pairing chunk for per-channel (group == K) quantization.
W4_DEFAULT_PACK_GROUP = 256


def pack_group_for(K: int, n_scale_groups: int) -> int:
    """Row-pairing chunk: the scale group when per-group, else the largest
    power of two <= 256 dividing K (per-channel)."""
    G = K // n_scale_groups
    if G < K:
        return G
    gp = W4_DEFAULT_PACK_GROUP
    while gp > 2 and K % gp:
        gp //= 2
    return gp


def quantize_w4(w: torch.Tensor, group_size: int = 128, symmetric: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Per-group int4 quantization of a ``[K, N]`` weight matrix.

    Returns ``(q int8 [K, N] in [-8, 7], scales f32 [K//G, N], zeros)``;
    zeros (f32, same signed domain as q) is None when symmetric, and
    dequant = (q - zero) * scale.
    """
    K, N = w.shape
    G = K if group_size in (-1, 0) else group_size
    assert K % G == 0, f"K={K} not divisible by group_size={G}"
    wg = w.to(torch.float32).reshape(K // G, G, N)
    if symmetric:
        absmax = wg.abs().amax(dim=1)
        scales = torch.clamp(div_scalar(absmax, 7.0), min=1e-8)
        q = torch.clamp(torch.round(wg / scales[:, None, :]), -8, 7)
        zeros = None
    else:
        wmax = wg.amax(dim=1)
        wmin = wg.amin(dim=1)
        scales = torch.clamp(div_scalar(wmax - wmin, 15.0), min=1e-8)
        zu = torch.clamp(torch.round(-wmin / scales), 0, 15)
        q = torch.clamp(torch.round(wg / scales[:, None, :]) + zu[:, None, :],
                        0, 15) - 8
        zeros = (zu - 8).to(torch.float32)
    return q.reshape(K, N).to(torch.int8), scales.to(torch.float32), zeros


E4M3_MAX = 448.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Round to float8_e4m3fn, nearest even, saturating at +-448 (infinities
    too; NaN stays NaN)."""
    return torch.clamp(x, -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)


def quantize_w8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (per output column) int8 quantization of ``[K, N]``:
    ``(q int8 [K, N], scales f32 [N])``, dequant = q * scale."""
    wf = w.to(torch.float32)
    scales = torch.clamp(div_scalar(wf.abs().amax(dim=0), 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / scales[None, :]), -128, 127)
    return q.to(torch.int8), scales


def quantize_fp8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel e4m3 quantization of ``[K, N]``: ``(q float8_e4m3fn
    [K, N], scales f32 [N])`` with scale = max(absmax, 1e-12) / 448."""
    wf = w.to(torch.float32)
    scales = div_scalar(torch.clamp(wf.abs().amax(dim=0), min=1e-12),
                        E4M3_MAX)
    return to_e4m3(wf / scales[None, :]), scales


def _nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo & 0xF) | (hi << 4) as int8 bytes."""
    b = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    return b.to(torch.uint8).view(torch.int8)


def _split_nibbles(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed (low, high) nibbles of int8 bytes, as int32."""
    p32 = p.to(torch.int32)
    lo = p32 & 0xF
    lo = lo - ((lo >= 8).to(torch.int32) << 4)
    return lo, p32 >> 4


def pack_w4(q: torch.Tensor, pack_group: int = 128) -> torch.Tensor:
    """Pack signed int4 ``[K, N]`` into K-paired int8 nibbles ``[K//2, N]``."""
    K, N = q.shape
    Gp = pack_group
    assert K % Gp == 0 and Gp % 2 == 0, (K, Gp)
    qc = q.reshape(K // Gp, 2, Gp // 2, N)
    return _nibbles(qc[:, 0], qc[:, 1]).reshape(K // 2, N)


def unpack_w4(packed: torch.Tensor, pack_group: int = 128) -> torch.Tensor:
    """Inverse of :func:`pack_w4` -> int8 values in [-8, 7], ``[K, N]``."""
    half, N = packed.shape
    Gp = pack_group
    assert half % (Gp // 2) == 0
    lo, hi = _split_nibbles(packed.reshape(half // (Gp // 2), Gp // 2, N))
    return torch.cat([lo, hi], dim=1).reshape(2 * half, N).to(torch.int8)


def dequantize_w4(packed: torch.Tensor, scales: torch.Tensor,
                  zeros: Optional[torch.Tensor] = None,
                  pack_group: Optional[int] = None) -> torch.Tensor:
    """Full dequantization of a K-paired packing to f32 ``[K, N]``."""
    K = packed.shape[0] * 2
    Gp = pack_group or pack_group_for(K, scales.shape[0])
    return _apply_scales(unpack_w4(packed, Gp), scales, zeros)


def _apply_scales(q: torch.Tensor, scales: torch.Tensor,
                  zeros: Optional[torch.Tensor]) -> torch.Tensor:
    K, N = q.shape
    G = K // scales.shape[0]
    qg = q.to(torch.float32).reshape(K // G, G, N)
    if zeros is not None:
        qg = qg - zeros.to(torch.float32)[:, None, :]
    return (qg * scales.to(torch.float32)[:, None, :]).reshape(K, N)


def choose_block_n(N: int, shards: int = 1) -> int:
    """Largest output-column tile in {1024..128} such that tiles divide N and
    shard evenly over `shards` ranks; 0 if none fits (K-paired packing)."""
    for bn in (1024, 512, 256, 128):
        if N % bn == 0 and (N // bn) % shards == 0:
            return bn
    return 0


def pack_w4_tiled(q: torch.Tensor, block_n: int) -> torch.Tensor:
    """Row-interleaved nibbles in output-column tiles ``[N//BN, K//2, BN]``."""
    K, N = q.shape
    assert K % 2 == 0 and N % block_n == 0
    pk = _nibbles(q[0::2], q[1::2])                       # [K/2, N]
    return pk.reshape(K // 2, N // block_n, block_n).permute(1, 0, 2) \
        .contiguous()


def unpack_w4_tiled(packed3: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_w4_tiled` -> int8 in [-8, 7], ``[K, N]``."""
    n_n, half, bn = packed3.shape
    pk = packed3.permute(1, 0, 2).reshape(half, n_n * bn)
    lo, hi = _split_nibbles(pk)
    return torch.stack([lo, hi], dim=1).reshape(2 * half, n_n * bn) \
        .to(torch.int8)


def dequantize_w4_any(packed: torch.Tensor, scales: torch.Tensor,
                      zeros: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize either packing (2-D K-paired or 3-D tiled) to f32."""
    if packed.dim() == 3:
        return _apply_scales(unpack_w4_tiled(packed), scales, zeros)
    return dequantize_w4(packed, scales, zeros)


def tiled_block_n(N: int) -> int:
    """Tile width for repacking a K-paired weight into the tiled layout the
    CUDA kernels read: `choose_block_n`, else 64 when it divides N."""
    return choose_block_n(N) or (64 if N % 64 == 0 else 0)


def to_tiled(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """A 2-D K-paired packing repacked as ``[N//BN, K//2, BN]`` tiles (no-op
    for a tiled packing)."""
    if packed.dim() == 3:
        return packed
    K = packed.shape[0] * 2
    N = packed.shape[1]
    bn = tiled_block_n(N)
    if not bn:
        raise NotImplementedError(
            f"N={N} has no multiple-of-64 tile width for the CUDA kernels")
    q = unpack_w4(packed, pack_group_for(K, scales.shape[0]))
    return pack_w4_tiled(q, bn)

"""Binary hypervector bit-packing and Hamming primitives.

Counterpart of ``repro.core.packing``. Packed HVs are ``torch.int32``
tensors holding the reference's uint32 bit patterns (``ndarray.view(
np.int32)``): torch has no shifts on ``uint32`` and no popcount op, and on
int32 ``>>`` is arithmetic, so every shift here is followed by a mask.
Bits are LSB-first within a word, as in the reference. The MXU
formulation (``bits_to_pm1``, ``hamming_matrix_mxu``) maps bit 0 to +1 and
bit 1 to -1, so ``dot(x, y) = D - 2 * hamming``.
"""
from __future__ import annotations

import torch

WORD_BITS = 32


def n_words(dim: int) -> int:
    if dim % WORD_BITS != 0:
        raise ValueError(f"Dhv must be a multiple of {WORD_BITS}, got {dim}")
    return dim // WORD_BITS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., D) {0,1} bits into (..., D//32) int32 words (LSB-first)."""
    d = bits.shape[-1]
    w = n_words(d)
    b = bits.to(torch.int32).reshape(*bits.shape[:-1], w, WORD_BITS)
    # 1 << b in int32: bit 31 weighs -2**31, so the sum of distinct bits is
    # the word's two's-complement value and no partial sum overflows.
    weights = torch.ones((), dtype=torch.int32, device=bits.device) << torch.arange(
        WORD_BITS, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """Unpack (..., W) int32 words into (..., W*32) {0,1} uint8 bits."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    out = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS).to(torch.uint8)
    if dim is not None:
        out = out[..., :dim]
    return out


def bits_to_pm1(bits: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """{0,1} bits -> {+1,-1}: bit 0 -> +1, bit 1 -> -1."""
    return (1 - 2 * bits.to(torch.int32)).to(dtype)


def packed_to_pm1(words: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """(..., W) packed words -> (..., 32W) +-1 values (bit 32w+b of word w)."""
    return bits_to_pm1(unpack_bits(words), dtype=dtype)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words (SWAR), int32 result.

    The sign bit is counted apart so every SWAR step runs on non-negative
    values and no int32 arithmetic can overflow.
    """
    v = words & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + (words < 0).to(torch.int32)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed HVs; broadcasts over leading dims."""
    return popcount(a ^ b).sum(dim=-1, dtype=torch.int32)


def hamming_matrix_packed(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming: q (Q, W) x r (R, W) -> (Q, R) int32 (backend ``vpu``)."""
    return popcount(q[:, None, :] ^ r[None, :, :]).sum(dim=-1, dtype=torch.int32)


def hamming_matrix_mxu(q: torch.Tensor, r: torch.Tensor, dim: int) -> torch.Tensor:
    """All-pairs Hamming via a +-1 dot, ``(dim - q.r) // 2`` over the first
    ``dim`` bits (backend ``mxu``).

    The dot runs in float32 on every device: each partial sum is an integer
    of magnitude <= dim < 2**24, so it is exact. (torch's ``int8 @ int8``
    returns int8 on the CPU and wraps for any dim above 127.)
    """
    qp = packed_to_pm1(q, dtype=torch.float32)[..., :dim]
    rp = packed_to_pm1(r, dtype=torch.float32)[..., :dim]
    dot = (qp @ rp.T).to(torch.int32)
    return (dim - dot) // 2

"""The integer arithmetic of the port's CUDA hamming_mxu kernel
(hamming_mxu/csrc/hamming_mxu.cu), mirrored step by step in numpy and held
against the reference's Pallas kernel (hamming_matrix_mxu_pallas, interpret
mode) with exact equality.

The kernel runs only on a GPU (chip_smoke.py holds it bit for bit against
its plain version); these tests guard the algebra its design rests on:

* the bit map: in a 16-word step lane 4g + t holds words 4t .. 4t + 3 of
  its row, and the step's 16 int8 m16n8k32 MMAs take byte bit p of words
  (2h, 2h + 1) of every lane, so each lane's 128 bits meet the 16 MMAs'
  k slots one to one;
* the operands: a B register is one AND of a packed word, bytes 0 or 2^p
  (-128 for p = 7), an A register the query's bits as +-a_p bytes, and
  every product is 8 (1 - 2q) r (p < 4) or 128 (1 - 2q) r (p >= 4);
* ham(q, r) = |q| + sum_k (1 - 2 q_k) r_k, from two accumulators
  (lo >> 3) + (hi >> 7), over 128-word chunks of A fragments;
* the rows split into one contiguous run of n8 tiles per warp.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.hamming_mxu.hamming_mxu import hamming_matrix_mxu_pallas  # noqa: E402

QT = 16
STEP_WORDS = 16          # csrc: one 16-byte load per lane and n8 tile
MMAS_PER_STEP = 16
KW = 128                 # csrc: words of A fragments staged per chunk
BYTE_BITS = 0x01010101


def _popc(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype(np.uint32)[..., None].view(np.uint8),
                         axis=-1).sum(axis=-1).astype(np.int64)


def _words(rng, *shape):
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    if w.size:
        w.reshape(-1)[0] = 0xFFFFFFFF
    return w


def mma_bits(m: int) -> tuple[int, int]:
    """csrc: MMA m of a step takes bit position p of every byte of the
    lane's words 2h (b0, a0/a1) and 2h + 1 (b1, a2/a3); m < 8 feed the lo
    accumulator, m >= 8 the hi one."""
    return (m & 3) + ((m >> 3) << 2), (m >> 2) & 1


def a_weight(p: int) -> int:
    """csrc pm1_weighted: the A byte of a 0 bit at byte bit p."""
    return -1 if p == 7 else 1 << (3 - (p & 3))


def as_s8(u32: np.ndarray) -> np.ndarray:
    """(..., ) uint32 registers -> (..., 4) int8 bytes, byte j = bits 8j.."""
    return u32.astype(np.uint32)[..., None].view(np.uint8).view(np.int8).astype(np.int64)


def b_register(w: np.ndarray, p: int) -> np.ndarray:
    """csrc: one AND per B register."""
    return w & np.uint32(BYTE_BITS << p)


def a_register(w: np.ndarray, p: int) -> np.ndarray:
    """csrc pm1_weighted: byte j is a_p for a 0 bit 8j + p and -a_p for a
    1 bit, built as zero * 0x01010101 + bits * (one - zero) mod 2^32."""
    a = a_weight(p)
    zero, one = a & 0xFF, -a & 0xFF
    bits = (w >> np.uint32(p)) & np.uint32(BYTE_BITS)
    return (np.uint32(zero * BYTE_BITS) + bits * np.uint32((one - zero) & 0xFFFFFFFF)
            ).astype(np.uint32)


def mma_s8(a_regs: np.ndarray, b_regs: np.ndarray) -> np.ndarray:
    """m16n8k32 .s8.s8.s32 from its lanes' fragments (PTX ISA): lane 4g + t
    holds A rows g (a0: k 4t.., a2: k 16 + 4t..) and g + 8 (a1, a3), B
    column g (b0: k 4t.., b1: k 16 + 4t..). a_regs (32, 4), b_regs
    (..., 32, 2) uint32 -> (..., 16, 8) int64."""
    a8 = as_s8(a_regs)                                   # (32, 4 regs, 4 bytes)
    A = np.zeros((16, 32), np.int64)
    b8 = as_s8(b_regs)                                   # (..., 32, 2, 4)
    B = np.zeros(b8.shape[:-3] + (32, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, 4 * t:4 * t + 4] = a8[lane, 0]
        A[g + 8, 4 * t:4 * t + 4] = a8[lane, 1]
        A[g, 16 + 4 * t:20 + 4 * t] = a8[lane, 2]
        A[g + 8, 16 + 4 * t:20 + 4 * t] = a8[lane, 3]
        B[..., 4 * t:4 * t + 4, g] = b8[..., lane, 0, :]
        B[..., 16 + 4 * t:20 + 4 * t, g] = b8[..., lane, 1, :]
    return A @ B


def warp_tiles(n_tiles: int, n_warps: int, gw: int) -> tuple[int, int]:
    """csrc: warp gw's contiguous run of n8 tiles."""
    return n_tiles * gw // n_warps, n_tiles * (gw + 1) // n_warps


def tile_by_design(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """numpy mirror of hamming_mxu.cu for one query tile (Q <= 16)."""
    Q, W = q.shape
    R = r.shape[0]
    n_tiles = -(-R // 8)
    qp = np.zeros((QT, W), np.uint32)
    qp[:Q] = q
    rp = np.zeros((n_tiles * 8, W), np.uint32)
    rp[:R] = r
    qn = _popc(qp).sum(axis=1)
    out = np.zeros((QT, n_tiles * 8), np.int64)
    for w0 in range(0, W, KW):
        nw = min(KW, W - w0)
        lo = np.zeros((n_tiles, 16, 8), np.int64)
        hi = np.zeros((n_tiles, 16, 8), np.int64)
        for s in range(-(-nw // STEP_WORDS)):
            # Lane 4g + t's words 4t .. 4t + 3 of the step: queries (rows g,
            # g + 8; zero past the chunk) and every tile's row g (zero past it).
            def lane_words(x, rows, v):
                w = w0 + s * STEP_WORDS + 4 * np.arange(4) + v     # by t
                ok = w < w0 + nw
                got = x[rows][..., np.minimum(w, W - 1)]
                return np.where(ok, got, 0).astype(np.uint32)
            for m in range(MMAS_PER_STEP):
                p, h = mma_bits(m)
                a = np.zeros((32, 4), np.uint32)
                b = np.zeros((n_tiles, 32, 2), np.uint32)
                for g in range(8):
                    for reg, v in enumerate((2 * h, 2 * h + 1)):
                        qa = lane_words(qp, g, v)                   # (4,) by t
                        qb = lane_words(qp, g + 8, v)
                        rv = lane_words(rp.reshape(n_tiles, 8, W), (slice(None), g), v)
                        a[4 * g:4 * g + 4, 2 * reg] = a_register(qa, p)
                        a[4 * g:4 * g + 4, 2 * reg + 1] = a_register(qb, p)
                        b[:, 4 * g:4 * g + 4, reg] = b_register(rv, p)
                (lo if m < 8 else hi)[...] += mma_s8(a, b)
        assert not (lo % 8).any() and not (hi % 128).any()
        dot = (lo >> 3) + (hi >> 7)                              # (tiles, 16, 8)
        out += dot.transpose(1, 0, 2).reshape(QT, -1)
    out += qn[:, None]
    return out[:Q, :R].astype(np.int32)


def reference(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    Q, W = q.shape
    R = r.shape[0]
    return np.asarray(hamming_matrix_mxu_pallas(
        jnp.asarray(q), jnp.asarray(r), dim=32 * W, q_tile=Q, r_tile=R,
        word_tile=1, interpret=True))


def test_bit_map_is_a_bijection_of_each_lanes_words():
    """Over a step's 16 MMAs, lane t's 2 registers x 4 bytes per MMA take
    every bit of its 4 words exactly once."""
    seen = []
    for m in range(MMAS_PER_STEP):
        p, h = mma_bits(m)
        for v in (2 * h, 2 * h + 1):
            seen += [32 * v + 8 * j + p for j in range(4)]
    assert sorted(seen) == list(range(128))


def test_operand_products_are_scaled_pm1_times_01():
    """Every (query bit, row bit, byte, bit position): the s8 product of the
    A and B bytes is 8 or 128 times (1 - 2q) r."""
    for p in range(8):
        scale = 8 if p < 4 else 128
        for j in range(4):
            for qbit in (0, 1):
                for rbit in (0, 1):
                    w_q = np.array([qbit << (8 * j + p)], np.uint32)
                    w_r = np.array([rbit << (8 * j + p)], np.uint32)
                    a = as_s8(a_register(w_q, p))[0, j]
                    b = as_s8(b_register(w_r, p))[0, j]
                    assert a * b == scale * (1 - 2 * qbit) * rbit
                    # The other bits of the word never leak into this byte.
                    noise = np.array([0xFFFFFFFF ^ (1 << (8 * j + p))], np.uint32)
                    assert as_s8(b_register(noise & ~w_r, p))[0, j] == 0
                    assert (as_s8(a_register(noise | w_q, p))[0, j]
                            == (a_weight(p) * (1 - 2 * qbit) + 128) % 256 - 128)


@pytest.mark.parametrize("Q", [16, 17])
@pytest.mark.parametrize("R", [24, 257])
@pytest.mark.parametrize("W", [1, 5, 9])
def test_int8_tile_matches_reference_kernel(Q, R, W):
    rng = np.random.default_rng(Q * 10_000 + R * 10 + W)
    q, r = _words(rng, Q, W), _words(rng, R, W)
    r[1] = 0
    want = reference(q, r)
    got = np.concatenate([tile_by_design(q[i:i + QT], r) for i in range(0, Q, QT)])
    assert (got == want).all()
    assert (want == _popc(q[:, None, :] ^ r[None, :, :]).sum(axis=-1)).all()


def test_int8_tile_over_two_chunks_matches_reference_kernel():
    """W > 128: the kernel stages A in 128-word chunks and adds each
    chunk's dot to the stored tile."""
    rng = np.random.default_rng(133)
    q, r = _words(rng, 3, KW + 5), _words(rng, 9, KW + 5)
    assert (tile_by_design(q, r) == reference(q, r)).all()


@pytest.mark.parametrize("n_tiles,n_warps", [(1, 8), (7, 8), (17_920, 2_112),
                                             (524_288, 2_112), (33, 16)])
def test_warp_runs_partition_the_tiles(n_tiles, n_warps):
    runs = [warp_tiles(n_tiles, n_warps, gw) for gw in range(n_warps)]
    assert runs[0][0] == 0 and runs[-1][1] == n_tiles
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = [hi - lo for lo, hi in runs]
    assert max(sizes) - min(sizes) <= 1

"""The integer arithmetic of the port's CUDA hamming_matrix and hdencode
kernels, mirrored step by step in numpy and held against the reference's
Pallas kernels (interpret mode) at the kernels' edge shapes.

The CUDA kernels themselves run only on a GPU (chip_smoke.py holds them bit
for bit against their plain versions); these tests guard the algebra their
designs rest on:

* hamming_matrix (csrc/hamming_matrix.cu): words zero-padded to 16-word
  steps, two binary m16n8k256 AND-popc MMAs per step in the kernel's
  fragment map, and ham = |q| + |r| - 2 * popc(q & r), with the |r| of each
  C column moved there by the kernel's shuffles;
* hdencode (csrc/hdencode.cu): valid peaks compacted through a 64-slot ring
  per warp, eight at a time through Harley-Seal carry-save adders into bit
  planes, and the top-down majority / tie compare against n >> 1.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.hamming import ops as ref_hops  # noqa: E402
from repro.kernels.hdencode import ops as ref_hd  # noqa: E402

# --------------------------------------------------------------------------
# hamming_matrix: binary tensor-core tile
# --------------------------------------------------------------------------

STEP_WORDS = 16          # csrc: two m16n8k256 MMAs per step
QT = 16


def _popc(x: np.ndarray) -> np.ndarray:
    """Popcount of every uint32 element."""
    return np.unpackbits(x.astype(np.uint32)[..., None].view(np.uint8),
                         axis=-1).sum(axis=-1).astype(np.int64)


def _words(rng, *shape):
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    if w.size:
        w.reshape(-1)[0] = 0xFFFFFFFF
    return w


def _swizzle(Wp: int) -> int:
    """csrc: 16-byte chunk u of an odd query row is stored at u ^ swz."""
    return 0 if Wp & 16 else 4


def _mma_and_popc(a_regs, b_regs):
    """One m16n8k256 .b1 AND-popc MMA from its 32 lanes' fragments, as the
    PTX ISA lays them out: lane 4g + t holds A rows g (a0, a2) and g + 8
    (a1, a3) at k = 32t.. (a0, a1) and 128 + 32t.. (a2, a3), and B column g
    at k = 32t.. (b0) and 128 + 32t.. (b1); 32 bits per register."""
    A = np.zeros((16, 8), np.uint32)      # (row, 32-bit k slot)
    B = np.zeros((8, 8), np.uint32)       # (col, 32-bit k slot)
    for lane in range(32):
        g, t = divmod(lane, 4)
        a0, a1, a2, a3 = a_regs[lane]
        b0, b1 = b_regs[lane]
        A[g, t], A[g + 8, t], A[g, 4 + t], A[g + 8, 4 + t] = a0, a1, a2, a3
        B[g, t], B[g, 4 + t] = b0, b1
    return _popc(A[:, None, :] & B[None, :, :]).sum(axis=-1)   # (16, 8)


def tile_by_design(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """numpy mirror of hamming_matrix.cu for one query tile (Q <= 16)."""
    Q, W = q.shape
    R = r.shape[0]
    Wp = -(-W // STEP_WORDS) * STEP_WORDS
    swz = _swizzle(Wp)
    # Staging: zero-padded rows, chunk u of odd rows at u ^ swz.
    s_q = np.zeros((QT, Wp // 4, 4), np.uint32)
    for row in range(Q):
        padded = np.zeros(Wp, np.uint32)
        padded[:W] = q[row]
        for u in range(Wp // 4):
            s_q[row, (u ^ swz) if row & 1 else u] = padded[4 * u:4 * u + 4]

    def chunk(row, u):
        return s_q[row, (u ^ swz) if row & 1 else u]

    qn = np.array([sum(_popc(chunk(row, u)).sum() for u in range(Wp // 4))
                   for row in range(QT)])
    out = np.zeros((QT, -(-R // 8) * 8), np.int64)
    for tile in range(-(-R // 8)):
        rows = [tile * 8 + g for g in range(8)]
        rp = np.zeros((8, Wp), np.uint32)
        for g, row in enumerate(rows):
            if row < R:
                rp[g, :W] = r[row]
        c = np.zeros((16, 8), np.int64)
        rn_lane = np.zeros(32, np.int64)
        for step_w in range(0, W, STEP_WORDS):
            a_lo, a_hi, b_lo, b_hi = [], [], [], []
            for lane in range(32):
                g, t = divmod(lane, 4)
                u = step_w // 4 + t
                a, b = chunk(g, u), chunk(g + 8, u)
                rv = rp[g, 4 * u:4 * u + 4]
                a_lo.append((a[0], b[0], a[1], b[1]))
                b_lo.append((rv[0], rv[1]))
                a_hi.append((a[2], b[2], a[3], b[3]))
                b_hi.append((rv[2], rv[3]))
                rn_lane[lane] += _popc(rv).sum()
            c += _mma_and_popc(a_lo, b_lo) + _mma_and_popc(a_hi, b_hi)
        # Quad sum of |r|, then the columns' |r| from lanes 8t and 8t + 4.
        rn_quad = rn_lane.reshape(8, 4).sum(axis=1).repeat(4)
        for lane in range(32):
            g, t = divmod(lane, 4)
            rn0, rn1 = rn_quad[8 * t], rn_quad[8 * t + 4]
            for e, rn in enumerate((rn0, rn1)):
                out[g, tile * 8 + 2 * t + e] = qn[g] + rn - 2 * c[g, 2 * t + e]
                out[g + 8, tile * 8 + 2 * t + e] = qn[g + 8] + rn - 2 * c[g + 8, 2 * t + e]
    return out[:Q, :R].astype(np.int32)


@pytest.mark.parametrize("Wp", [16, 32, 48, 128, 3632])
def test_query_swizzle_is_a_permutation_of_each_row(Wp):
    swz = _swizzle(Wp)
    u = np.arange(Wp // 4)
    assert sorted(u ^ swz) == list(u)
    # A quarter-warp reads chunk 4s + t of an even and an odd row: in the
    # 8 x 16-byte bank groups, the two rows never collide.
    for s in range(Wp // 16):
        even = {(4 * s + t) % 8 for t in range(4)}
        odd = {((Wp // 4) + ((4 * s + t) ^ swz)) % 8 for t in range(4)}
        assert len(even) == len(odd) == 4 and not even & odd


@pytest.mark.parametrize("Q,R,W", [(16, 43, 1), (16, 43, 9), (1, 43, 128),
                                   (16, 1, 128), (16, 7, 16), (5, 8 * 4 + 3, 7),
                                   (16, 16, 33)])
def test_binary_mma_tile_matches_reference_kernel(Q, R, W):
    rng = np.random.default_rng(Q * 1000 + R * 10 + W)
    q, r = _words(rng, Q, W), _words(rng, R, W)
    if R > 1:
        r[1] = 0
    want = np.asarray(ref_hops.hamming_matrix(jnp.asarray(q), jnp.asarray(r),
                                              interpret=True))
    assert (tile_by_design(q, r) == want).all()


def test_binary_mma_second_query_tile_matches_reference_kernel():
    """Q = 17: the kernel's grid runs a second, one-query tile."""
    rng = np.random.default_rng(17)
    q, r = _words(rng, 17, 9), _words(rng, 19, 9)
    want = np.asarray(ref_hops.hamming_matrix(jnp.asarray(q), jnp.asarray(r),
                                              interpret=True))
    got = np.concatenate([tile_by_design(q[:16], r), tile_by_design(q[16:], r)])
    assert (got == want).all()


# --------------------------------------------------------------------------
# hdencode: bit-sliced majority counters
# --------------------------------------------------------------------------

GROUP = 8
RING = 64


def upper_planes(P: int) -> int:
    """csrc: NU = bit_length(P >> 3), the general instantiation past 8."""
    nu = (P >> 3).bit_length()
    return nu if nu <= 8 else 28


def ring_groups(valid: np.ndarray):
    """The warp's compaction, 32 peaks a round: ballot ranks into a 64-slot
    ring, groups of eight taken while eight are pending, then the tail.
    Returns the peak indices of every group and the largest live count."""
    ring = [None] * RING
    head = tail = 0
    groups, most = [], 0
    for base in range(0, valid.size, 32):
        ballot = [p for p in range(base, min(base + 32, valid.size)) if valid[p]]
        for rank, p in enumerate(ballot):
            slot = (tail + rank) % RING
            assert ring[slot] is None          # never overwrites a live peak
            ring[slot] = p
        tail += len(ballot)
        most = max(most, tail - head)
        while tail - head >= GROUP:
            groups.append([ring[(head + k) % RING] for k in range(GROUP)])
            for k in range(GROUP):
                ring[(head + k) % RING] = None
            head += GROUP
    if tail > head:
        groups.append([ring[(head + k) % RING] for k in range(tail - head)])
    return groups, most


def _csa(a, b, c):
    return (a & b) | (a & c) | (b & c), a ^ b ^ c        # carry, sum


def planes_add8(planes, x):
    """Harley-Seal: eight bound words into ones, twos, fours; the group's
    eights ripple into the upper planes (carry out of the top dropped)."""
    ones, twos, fours, up = planes
    twos_a, ones = _csa(ones, x[0], x[1])
    twos_b, ones = _csa(ones, x[2], x[3])
    fours_a, twos = _csa(twos, twos_a, twos_b)
    twos_a, ones = _csa(ones, x[4], x[5])
    twos_b, ones = _csa(ones, x[6], x[7])
    fours_b, twos = _csa(twos, twos_a, twos_b)
    eights, fours = _csa(fours, fours_a, fours_b)
    for j in range(len(up)):
        carry = up[j] & eights
        up[j] = up[j] ^ eights
        eights = carry
    return ones, twos, fours, up


def majority(planes, n: int, tie):
    """Top-down compare of the count planes with h = n >> 1: count > h sets
    the bit, count == h takes the tie bit when n is even."""
    ones, twos, fours, up = planes
    stack = [ones, twos, fours, *up]
    h = n >> 1
    full = np.uint32(0xFFFFFFFF)
    gt = np.zeros_like(ones)
    eq = np.full_like(ones, full)
    for j in range(len(stack) - 1, -1, -1):
        c = stack[j]
        if (h >> j) & 1:
            eq = eq & c
        else:
            gt = gt | (eq & c)
            eq = eq & ~c
    even = full if n % 2 == 0 else np.uint32(0)
    return gt | (eq & tie & even)


def hdencode_by_design(bins, levels, mask, id_hvs, level_hvs, tiebreak):
    B, P = bins.shape
    W = id_hvs.shape[1]
    nu = upper_planes(P)
    out = np.zeros((B, W), np.uint32)
    zero = np.zeros(W, np.uint32)
    for b in range(B):
        planes = (zero, zero, zero, [zero] * nu)
        groups, most = ring_groups(mask[b])
        assert most <= GROUP - 1 + 32
        for grp in groups:
            x = [id_hvs[bins[b, p]] ^ level_hvs[levels[b, p]] for p in grp]
            planes = planes_add8(planes, x + [zero] * (GROUP - len(x)))
        out[b] = majority(planes, int(mask[b].sum()), tiebreak)
    return out


def _spectra(rng, B, P, F, L):
    bins = rng.integers(0, F, (B, P)).astype(np.int32)
    levels = rng.integers(0, L, (B, P)).astype(np.int32)
    mask = rng.random((B, P)) < 0.7
    mask[0] = False                       # n = 0: the tie-break HV
    if B > 1:
        mask[1] = False
        mask[1, :2] = True                # two peaks: ties wherever they differ
    return bins, levels, mask


def _reference(bins, levels, mask, id_hvs, level_hvs, tiebreak):
    return np.asarray(ref_hd.hdencode(
        jnp.asarray(bins), jnp.asarray(levels), jnp.asarray(mask),
        jnp.asarray(id_hvs), jnp.asarray(level_hvs), jnp.asarray(tiebreak),
        interpret=True))


@pytest.mark.parametrize("B,P,W", [(4, 1, 4), (4, 63, 4), (3, 100, 7),
                                   (1, 64, 4), (5, 33, 1)])
def test_bit_sliced_encode_matches_reference_kernel(B, P, W):
    rng = np.random.default_rng(B * 1000 + P * 10 + W)
    F, L = 40, 8
    id_hvs, level_hvs = _words(rng, F, W), _words(rng, L, W)
    tiebreak = _words(rng, W)
    bins, levels, mask = _spectra(rng, B, P, F, L)
    args = (bins, levels, mask, id_hvs, level_hvs, tiebreak)
    got = hdencode_by_design(*args)
    assert (got == _reference(*args)).all()
    assert (got[0] == tiebreak).all()


def test_bit_sliced_top_plane_holds_a_count_of_64():
    """P = 64, every peak valid with one bin and one level: each set bit of
    the bound word counts 64, which needs the seventh plane."""
    rng = np.random.default_rng(64)
    B, P, W = 3, 64, 4
    id_hvs, level_hvs, tiebreak = _words(rng, 10, W), _words(rng, 4, W), _words(rng, W)
    bins = np.repeat(rng.integers(0, 10, (B, 1)), P, axis=1).astype(np.int32)
    levels = np.repeat(rng.integers(0, 4, (B, 1)), P, axis=1).astype(np.int32)
    mask = np.ones((B, P), bool)
    assert 3 + upper_planes(P) == 7
    got = hdencode_by_design(bins, levels, mask, id_hvs, level_hvs, tiebreak)
    assert (got == _reference(bins, levels, mask, id_hvs, level_hvs, tiebreak)).all()
    assert (got == id_hvs[bins[:, 0]] ^ level_hvs[levels[:, 0]]).all()


@pytest.mark.parametrize("P", [1, 7, 8, 63, 64, 100, 2047, 2100])
def test_planes_and_majority_count_every_n(P):
    """For every valid count n <= P (sampled past 300) and every bit count
    c <= n: the planes hold c exactly and the compare gives 2c > n, with
    the tie bit on 2c == n."""
    nu = upper_planes(P)
    assert P < 2 ** (3 + nu)
    ns = range(P + 1) if P <= 300 else sorted({0, 1, 2, 3, 255, 256, 257, P - 1, P})
    full = np.uint32(0xFFFFFFFF)
    for n in ns:
        # bit j of lane word set in the first c_j of n peaks
        cs = np.linspace(0, n, 32).astype(np.int64)
        zero = np.zeros(1, np.uint32)
        planes = (zero, zero, zero, [zero] * nu)
        words = [np.array([sum(1 << j for j in range(32) if k < cs[j])], np.uint32)
                 for k in range(n)]
        for g in range(0, n, GROUP):
            x = words[g:g + GROUP]
            planes = planes_add8(planes, x + [zero] * (GROUP - len(x)))
        ones, twos, fours, up = planes
        stack = [ones, twos, fours, *up]
        count = [sum(((int(p[0]) >> j) & 1) << i for i, p in enumerate(stack))
                 for j in range(32)]
        assert count == list(cs)
        for tie in (np.uint32(0), full):
            got = int(majority(planes, n, np.array([tie]))[0])
            want = sum(1 << j for j in range(32)
                       if 2 * cs[j] > n or (2 * cs[j] == n and tie))
            assert got == want

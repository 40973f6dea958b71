"""The algebra of the port's grouped fused search kernels
(kernels/csrc/fused_grouped.cuh with the binary route of
hamming/csrc/fused_search.cu and the +-1 int8 route of
hamming_mxu/csrc/fused_search_mxu.cu), mirrored lane by lane in numpy and
held against the reference's Pallas fused kernels in interpret mode.

The CUDA kernels run only on a GPU (chip_smoke.py holds them bit for bit
against their plain versions); these tests guard what their design rests
on:

* the groups: GROUP consecutive 16-query tiles per CTA walk the union of
  their row ranges, cut into contiguous splits, and each tile is masked to
  its own range (``ops.group_spans`` mirrors the kernel's union);
* the staged queries: the swizzled shared-memory rows each lane reads for
  its A fragments (both routes) are the words the MMA needs;
* the epilogue on the C fragments: lane 4g + t holds queries g, g + 8 and
  rows 2t, 2t + 1 of every n8 tile, |r| moved there by shuffles, and the
  filter against each list's k-th sim;
* the winners: concurrent atomicMax chains leave each list sorted with the
  k best keys, and the splits merge by composite key;
* any k and W (also tests/test_torch_fused_large_k.py, and here the
  resident pipeline at top_k = 100): past k = 64 or the shared-memory
  bound the lists live in device memory, shared by all splits (chains
  that start below the slots a binary search reads above the key), and
  wide queries are staged in word chunks read through a shifted base.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.data.spectra import LibraryConfig, make_dataset  # noqa: E402
from repro.kernels.hamming import ops as ref_hops  # noqa: E402
from repro.kernels.hamming_mxu import ops as ref_mops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.convert import packed_to_torch  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data.spectra import SpectraSet  # noqa: E402
from repro_torch.kernels.hamming import ops as hops  # noqa: E402
from repro_torch.kernels.hamming import ref as href  # noqa: E402

QT, GROUP, NT, NWARPS = 16, hops.GROUP, 4, 8
PASS_ROWS = NWARPS * NT * 8
PAD_PMZ = np.float32(np.finfo(np.float32).max)
PAD_Q_CHARGE = -(2 ** 30)
LANES = np.arange(32)
G_OF, T_OF = LANES >> 2, LANES & 3


def _popc(x):
    """Popcount of every uint32 element, summed over the last axis."""
    x = np.asarray(x, np.uint32)
    return np.unpackbits(x[..., None].view(np.uint8), axis=-1).sum(axis=(-1, -2)).astype(np.int64)


def _pm1_dot(q, r):
    """The +-1 int8 dot of two packed rows: each bit -> +1 (0) or -1 (1)."""
    bits = lambda x: np.unpackbits(np.asarray(x, np.uint32)[..., None].view(np.uint8),
                                   axis=-1, bitorder="little").reshape(*x.shape[:-1], -1)
    return int(((1 - 2 * bits(q).astype(np.int64)) * (1 - 2 * bits(r).astype(np.int64))).sum())


# --------------------------------------------------------------------------
# Groups and splits
# --------------------------------------------------------------------------


def spans_by_loop(starts, rk, n_rows, group=GROUP):
    out = []
    for g0 in range(0, len(starts), group):
        s = starts[g0:g0 + group]
        lo = min(s)
        out.append((lo, max(lo, min(max(s) + rk, n_rows))))
    return np.array(out, np.int64)


@pytest.mark.parametrize("starts", [[0], [0, 0], [5, 9, 9, 40],
                                    list(range(0, 900, 100)),       # G + 1 tiles
                                    [300, 10, 300, 0, 7, 7, 7, 7, 7, 999],
                                    [990] * 3])                     # past n_rows
def test_group_spans_are_the_union_of_each_groups_scans(starts):
    rk, n_rows = 64, 1000
    got = hops.group_spans(torch.tensor(starts, dtype=torch.int32), rk, n_rows)
    assert (got.numpy() == spans_by_loop(starts, rk, n_rows)).all()
    for gi, (lo, hi) in enumerate(got.tolist()):
        for s in starts[gi * GROUP:(gi + 1) * GROUP]:
            scan = set(range(s, min(s + rk, n_rows)))
            assert scan <= set(range(lo, hi))            # every tile's rows covered


@pytest.mark.parametrize("n_tiles,rk,n_sms", [(1, 143360, 132), (1001, 143360, 132),
                                             (16, 1000, 132), (5000, 64, 132),
                                             (8, 4096, 1)])
def test_split_count_fills_the_card_and_keeps_rows_per_split(n_tiles, rk, n_sms):
    n = hops.n_splits_for(n_tiles, rk, n_sms)
    n_groups = -(-n_tiles // GROUP)
    assert 1 <= n <= max(1, -(-rk // hops.MIN_SPLIT_ROWS))
    if n < -(-rk // hops.MIN_SPLIT_ROWS):
        assert n * n_groups >= hops.FUSED_WAVES * n_sms


def split_chunks(lo, hi, n_splits):
    """The kernel's [begin, end) of each split of a group's union."""
    span = hi - lo
    chunk = (-(-span // n_splits) + 31) // 32 * 32
    return [(lo + min(span, s * chunk), min(lo + min(span, s * chunk) + chunk, hi))
            for s in range(n_splits)]


@pytest.mark.parametrize("span,n_splits", [(0, 3), (1, 1), (31, 4), (143360, 5),
                                           (1000, 7), (64, 65)])
def test_splits_partition_the_union(span, n_splits):
    chunks = split_chunks(100, 100 + span, n_splits)
    rows = [r for b, e in chunks for r in range(b, e)]
    assert rows == list(range(100, 100 + span))
    assert all((b - 100) % 32 == 0 for b, e in chunks if e > b)


# --------------------------------------------------------------------------
# Staged queries: the words each lane reads
# --------------------------------------------------------------------------


def chunk_swizzle(qs):
    return 0 if qs & 16 else 4


def stage_chunk(qg, W, c0, qs):
    """fused_grouped.cuh's stage_queries(c0): words [c0, c0 + qs) of each
    row (zero past W) in rows of qs words, 16-byte chunk u of an odd row
    stored at u ^ swz."""
    R, swz = qg.shape[0], chunk_swizzle(qs)
    seg = np.zeros((R, qs), np.uint32)
    n = max(0, min(W, c0 + qs) - c0)
    seg[:, :n] = qg[:, c0:c0 + n]
    dst = np.arange(qs // 4)[None, :] ^ (swz * (np.arange(R) & 1))[:, None]
    s_q = np.zeros((R, qs // 4, 4), np.uint32)
    s_q[np.arange(R)[:, None], dst] = seg.reshape(R, qs // 4, 4)
    return s_q.reshape(R, qs)


def stage_queries(qg, W):
    """The staging of all Wp words at once (W rounded up to 16 words)."""
    Wp = -(-W // 16) * 16
    return stage_chunk(qg, W, 0, Wp), Wp, chunk_swizzle(Wp)


def lane_words(qg, W, qs, route):
    """The query words the lanes read, step by step, from queries staged in
    chunks of qs words (qs = Wp: whole), through the base shifted back by
    the chunk's first word c0: the binary route's four words at chunk
    ((w0 >> 2) + t) ^ qsw, the +-1 route's word w at 4 * ((w >> 2) ^ qsw) +
    (w & 3). Returns (rows, Wp) with the binary route's reads past W."""
    Wp = -(-W // 16) * 16
    q_steps, qsw = qs // 16, np.where(G_OF & 1, chunk_swizzle(qs), 0)
    out = np.zeros((qg.shape[0], Wp), np.uint32)
    for c0 in range(0, Wp, qs):
        flat = stage_chunk(qg, W, c0, qs).reshape(-1)
        for s in range(c0 // 16, min(c0 // 16 + q_steps, Wp // 16)):
            for gi, h in itertools.product(range(qg.shape[0] // QT), (0, 8)):
                rows = gi * QT + G_OF + h
                if route == "binary":
                    u = ((16 * s >> 2) + T_OF) ^ qsw
                    idx = rows[:, None] * qs + 4 * u[:, None] + np.arange(4) - c0
                    out[rows[:, None], 16 * s + 4 * T_OF[:, None] + np.arange(4)] = flat[idx]
                else:
                    for w in range(16 * s, min(16 * s + 16, W)):
                        out[rows, w] = flat[rows * qs + 4 * ((w >> 2) ^ qsw) + (w & 3) - c0]
    return out


@pytest.mark.parametrize("W", [1, 7, 8, 16, 48, 128, 256])
def test_lanes_read_their_fragment_words_from_the_staged_queries(W):
    rng = np.random.default_rng(W)
    qg = rng.integers(0, 2 ** 32, (GROUP * QT, W), dtype=np.uint64).astype(np.uint32)
    s_q, Wp, swz = stage_queries(qg, W)
    padded = np.zeros((GROUP * QT, Wp), np.uint32)
    padded[:, :W] = qg
    qsw = np.where(G_OF & 1, swz, 0)
    for gi in range(GROUP):
        for h in (0, 8):
            rows = gi * QT + G_OF + h
            # binary route: chunk ((w0 >> 2) + t) ^ qsw, four words
            for w0 in range(0, W, 16):
                u = ((w0 >> 2) + T_OF) ^ qsw
                got = s_q[rows[:, None], 4 * u[:, None] + np.arange(4)]
                want = padded[rows[:, None], w0 + 4 * T_OF[:, None] + np.arange(4)]
                assert (got == want).all()
            # +-1 route: word w at 4 * ((w >> 2) ^ qsw) + (w & 3)
            for w in range(W):
                got = s_q[rows, 4 * ((w >> 2) ^ qsw) + (w & 3)]
                assert (got == qg[rows, w]).all()
    # The two rows of a quarter-warp (g even, g + 1) never share a bank group.
    for s in range(Wp // 16):
        even = {(4 * s + t) % 8 for t in range(4)}
        odd = {(Wp // 4 + ((4 * s + t) ^ swz)) % 8 for t in range(4)}
        assert not even & odd


# (W, qs): whole staging (qs = Wp) and chunks of 32-word multiples, a last
# chunk past W, and the launcher's chunks at W = 4,096 (288 words for the
# binary route, 224 with the +-1 route's A slice).
STAGING = [(7, 16), (48, 32), (130, 64), (300, 96), (4096, 288), (4096, 224)]


@pytest.mark.parametrize("W,qs", STAGING)
def test_lanes_read_their_words_from_chunked_staging(W, qs):
    rng = np.random.default_rng(W + qs)
    qg = rng.integers(0, 2 ** 32, (2 * QT, W), dtype=np.uint64).astype(np.uint32)
    for route in ("binary", "pm1"):
        got = lane_words(qg, W, qs, route)
        assert (got[:, :W] == qg).all(), route
        assert not got[:, W:].any()                 # zeros past W


@pytest.mark.parametrize("W,k,scratch", [(2496, 1, 0), (2432, 1, 4096), (4096, 4, 0),
                                         (4096, 1024, 4096), (128, 65, 0)])
def test_device_list_plan_fits_shared_memory(W, k, scratch):
    """The device-list path's shared memory (GROUP tiles' staged chunks,
    rings, scratch) fits, in chunks of 32-word multiples where Wp does not."""
    plan = hops.fused_plan(W, k, scratch)
    wp = -(-W // 16) * 16
    assert plan.lists == "global" and plan.group == GROUP
    smem = (4 * GROUP * QT * plan.query_words + hops.FUSED_RING_BYTES
            + scratch * GROUP)
    assert smem <= hops.FUSED_SMEM_BUDGET
    if plan.query_words < wp:
        assert plan.query_words % 32 == 0
        assert smem + 4 * GROUP * QT * 32 > hops.FUSED_SMEM_BUDGET


# --------------------------------------------------------------------------
# Winners: concurrent atomicMax chains and the threshold
# --------------------------------------------------------------------------


def chain_steps(lst, key, start=0):
    """insert_atomic as a generator: one atomicMax per step, from slot
    ``start``."""
    for i in range(start, len(lst)):
        if not key:
            return
        old = lst[i]
        lst[i] = max(old, key)
        key = min(old, key)
        yield


def search_start(lst, key):
    """insert_atomic_from's binary search: below every slot read above the
    key."""
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if lst[mid] > key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def insert_atomic(lst, key):
    list(chain_steps(lst, key))


def insert_atomic_from(lst, key):
    list(chain_steps(lst, key, search_start(lst, key)))


def threshold(lst):
    """list_threshold: the high word (sim) of the k-th key."""
    return lst[-1] >> 32


@pytest.mark.parametrize("start", ["top", "search"])
@pytest.mark.parametrize("k,seed", [(1, 0), (4, 1), (16, 2), (3, 3), (70, 4)])
def test_concurrent_atomic_chains_keep_the_top_k(k, seed, start):
    """Chains that interleave step by step leave the top k, also when each
    starts where its binary search, read when it starts, puts it (the
    device lists: other chains move the list on while it walks)."""
    rng = np.random.default_rng(seed)
    sims = rng.integers(0, 6, 200)              # heavy sim ties
    rows = rng.permutation(200)
    keys = [(int(s) << 32) | (0xFFFFFFFF - int(r)) for s, r in zip(sims, rows)]
    lst = [0] * k
    pending = list(keys)
    live, started = [], []
    while pending or live:
        # start some chains, each only when its sim reaches the threshold
        for _ in range(rng.integers(0, 4)):
            if pending:
                key = pending.pop()
                if (key >> 32) >= threshold(lst):
                    live.append(chain_steps(lst, key, 0 if start == "top"
                                            else search_start(lst, key)))
                    started.append(key)
        if live:
            i = rng.integers(0, len(live))
            if next(live[i], StopIteration) is StopIteration:
                live.pop(i)
        # the k-th slot is a safe threshold: at least k started keys reach it
        if lst[-1]:
            assert sum(1 for x in started if x >= lst[-1]) >= k
    assert lst == sorted(keys, reverse=True)[:k]


# --------------------------------------------------------------------------
# The whole kernel, lane by lane
# --------------------------------------------------------------------------


def offer_quad(lists, list_of_lane, m, keys, insert):
    """offer_quad: per round each lane puts up its best flagged key, each
    quad's best is inserted (``insert``: insert_atomic or, for lists in
    device memory, insert_atomic_from), and lanes drop pairs below their
    list's k-th sim; m (32,) bit masks, keys[lane][bit]."""
    m = list(m)
    while any(m):
        best = [max((keys[ln][b] for b in range(2 * NT) if m[ln] >> b & 1), default=0)
                for ln in range(32)]
        for ln in range(32):
            top = max(best[4 * (ln // 4):4 * (ln // 4) + 4])
            if best[ln] and best[ln] == top:
                insert(lists[list_of_lane[ln]], best[ln])
                m[ln] &= ~(1 << keys[ln].index(best[ln]))
        for ln in range(32):
            thr = threshold(lists[list_of_lane[ln]])
            for b in range(2 * NT):
                if keys[ln][b] >> 32 < thr:
                    m[ln] &= ~(1 << b)


def epilogue(lists, gi, h, base, end, start, rb, rn_quad, qg, dq, qp, qc, rp, rc, *,
             rk, dim, route, std_scale, open_tol, insert):
    """The C-fragment epilogue of one (tile gi, query half h) for one warp
    pass: quick filter, warp vote, exact masks, then offer_quad per list."""
    f32 = np.float32
    keys, sims, cand, d_of = [], [], [0] * 32, []
    l_std = [gi * 2 * QT + 2 * (g + h) for g in G_OF]
    thr_o = [threshold(lists[l + 1]) for l in l_std]
    for lane in range(32):
        g, t = divmod(lane, 4)
        qi = gi * QT + g + h
        ks, ss, ds = [], [], []
        for nt, e in itertools.product(range(NT), range(2)):
            src = 8 * t + 4 * e                     # lane holding the column's row
            row = base + nt * 8 + 2 * t + e
            if route == "binary":
                c = int(_popc(qg[qi] & rb[nt, src]))
                sim = int(dq[qi]) - int(rn_quad[nt, src]) + 2 * c
            else:
                dot = _pm1_dot(qg[qi], rb[nt, src])
                sim = dim - ((dim - dot) >> 1)
            live = row < end
            rpv = rp[row] if live else PAD_PMZ
            rcv = rc[row] if live else -1
            d = abs(f32(qp[qi]) - f32(rpv))
            b = 2 * nt + e
            in_tile = 0 <= row - start < rk
            if in_tile and rcv == qc[qi] and (sim >= thr_o[lane]
                                              or d <= f32(qp[qi]) * f32(std_scale)):
                cand[lane] |= 1 << b
            ks.append((sim << 32) | (0xFFFFFFFF - row))
            ss.append(sim)
            ds.append((d, rpv))
        keys.append(ks)
        sims.append(ss)
        d_of.append(ds)
    if not any(cand):
        return
    thr_s = [threshold(lists[l]) for l in l_std]
    m_std, m_open = [0] * 32, [0] * 32
    for lane, b in itertools.product(range(32), range(2 * NT)):
        qi = gi * QT + lane // 4 + h
        d, rpv = d_of[lane][b]
        if cand[lane] >> b & 1 and rpv < PAD_PMZ:
            sim = sims[lane][b]
            if sim >= thr_s[lane] and d <= f32(qp[qi]) * f32(std_scale):
                m_std[lane] |= 1 << b
            if sim >= thr_o[lane] and d <= f32(open_tol):
                m_open[lane] |= 1 << b
    offer_quad(lists, l_std, m_std, keys, insert)
    offer_quad(lists, [l + 1 for l in l_std], m_open, keys, insert)


def fused_by_design(q, qp, qc, r, rp, rc, tile_start, *, rk, dim, k, n_splits,
                    route, std_scale, open_tol, lists="shared", query_words=None):
    """numpy mirror of fused_grouped_partial + fused_search_merge over
    16-query tiles: groups, splits, warp passes (round-robin over warps),
    the C-fragment epilogue with per-pass thresholds, the quads' offers and
    the atomic chains, then the split merge. ``lists="global"``: one list
    per (tile, list) for all splits, whose passes interleave, with
    insert_atomic_from, then the decode. ``query_words``: the queries are
    staged in chunks of that many words and the C fragments take the words
    the lanes read from them. Returns (std_sim, std_row, open_sim,
    open_row)."""
    n_tiles, W = len(tile_start), q.shape[1]
    n_rows = r.shape[0]
    insert = insert_atomic if lists == "shared" else insert_atomic_from
    partial = np.zeros((n_tiles, n_splits, 2 * QT, k), np.uint64)
    for grp, (lo, hi) in enumerate(spans_by_loop(list(tile_start), rk, n_rows)):
        t0 = grp * GROUP
        ng = min(GROUP, n_tiles - t0)
        qg = np.zeros((GROUP * QT, W), np.uint32)
        qg[:ng * QT] = q[t0 * QT:(t0 + ng) * QT]
        dq = dim - _popc(qg)
        if query_words is not None:
            qg = lane_words(qg, W, query_words, route)[:, :W]
        shared = [[0] * k for _ in range(GROUP * 2 * QT)]
        passes = []           # per split: (its lists, [(base, end), ...])
        for split, (begin, end) in enumerate(split_chunks(lo, hi, n_splits)):
            own = [[0] * k for _ in range(GROUP * 2 * QT)] if lists == "shared" else shared
            bases = [begin + w * 32 + i * PASS_ROWS for i in range(-(-(end - begin) // PASS_ROWS))
                     for w in range(NWARPS)]
            passes.append((own, [(b, end) for b in bases if b < end]))
        # Device lists: the splits' CTAs run at once, so their passes
        # interleave; shared lists: each split on its own.
        order = ([(s, i) for i in range(max(len(p) for _, p in passes))
                  for s in range(n_splits) if i < len(passes[s][1])]
                 if lists == "global" else
                 [(s, i) for s in range(n_splits) for i in range(len(passes[s][1]))])
        for split, i in order:
            lists_of, (base, end) = passes[split][0], passes[split][1][i]
            # B rows (lane group g of n-tile nt) and C columns (2t + e)
            brow = base + np.arange(NT)[:, None] * 8 + G_OF[None, :]       # (NT, 32)
            blive = brow < end
            rb = np.where(blive[..., None], r[np.minimum(brow, n_rows - 1)], 0)
            rn_lane = np.zeros((NT, 32), np.int64)
            for w0 in range(0, W, 16):
                cols = w0 + 4 * T_OF[:, None] + np.arange(4)                # (32, 4)
                words = np.where(cols < W, rb[:, LANES[:, None], np.minimum(cols, W - 1)], 0)
                rn_lane += _popc(words)
            rn_quad = rn_lane.reshape(NT, 8, 4).sum(axis=2).repeat(4, axis=1)
            for gi in range(ng):
                start = tile_start[t0 + gi]
                for h in (0, 8):
                    epilogue(lists_of, gi, h, base, end, start, rb, rn_quad, qg, dq,
                             qp[t0 * QT:], qc[t0 * QT:], rp, rc, rk=rk, dim=dim,
                             route=route, std_scale=std_scale, open_tol=open_tol,
                             insert=insert)
        # Device lists: one list for all splits, so the merge below only
        # decodes it.
        for split, (own, _) in enumerate(passes if lists == "shared" else passes[:1]):
            for gi in range(ng):
                for li in range(2 * QT):
                    partial[t0 + gi, split, li] = own[gi * 2 * QT + li]
    outs = [np.full((n_tiles * QT, k), -1, np.int32) for _ in range(4)]
    for tile, li in itertools.product(range(n_tiles), range(2 * QT)):
        # fused_search_decode takes the device list slot by slot;
        # fused_search_merge merges the splits' lists by key.
        best = ([int(x) for x in partial[tile, 0, li]] if lists == "global" else
                sorted((int(x) for x in partial[tile, :, li].reshape(-1) if x), reverse=True)[:k])
        sim_o, row_o = outs[2 * (li & 1)], outs[2 * (li & 1) + 1]
        for i, key in enumerate(best):
            if key:
                sim_o[tile * QT + li // 2, i] = key >> 32
                row_o[tile * QT + li // 2, i] = 0xFFFFFFFF - (key & 0xFFFFFFFF)
    return tuple(outs)


def _reference(mod, q, r, qp, rp, qc, rc, starts, *, rk, dim, k):
    """The reference's Pallas kernel (interpret mode) once per 16-query
    tile, rows made global."""
    outs = []
    for b, s in enumerate(starts):
        qs, rs = slice(b * QT, (b + 1) * QT), slice(s, s + rk)
        ss, si, os_, oi = (np.asarray(x) for x in mod.fused_search(
            *(jnp.asarray(x) for x in (q[qs], r[rs], qp[qs], rp[rs], qc[qs], rc[rs])),
            dim=dim, k=k, interpret=True))
        outs.append((ss, np.where(si >= 0, si + s, -1), os_, np.where(oi >= 0, oi + s, -1)))
    return [np.concatenate(c) for c in zip(*outs)]


def _case(seed, W, starts, n_rows, rk):
    """Tie-heavy rows (8 distinct HVs), sorted pmz, a padded tail, queries
    near their tile's rows with std-window hits and one padded query per
    tile."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2 ** 32, (8, W), dtype=np.uint64).astype(np.uint32)
    r = pool[rng.integers(0, 8, n_rows)]
    rp = np.sort(rng.uniform(400.0, 420.0, n_rows)).astype(np.float32)
    rc = rng.integers(2, 4, n_rows).astype(np.int32)
    rp[-6:], rc[-6:] = PAD_PMZ, -1
    Q = len(starts) * QT
    src = np.minimum(np.repeat(starts, QT) + rng.integers(0, rk, Q), n_rows - 7)
    q = r[src].copy()
    q[1::3] = rng.integers(0, 2 ** 32, (len(q[1::3]), W), dtype=np.uint64).astype(np.uint32)
    qp = (rp[src] + rng.uniform(-0.6, 0.6, Q)).astype(np.float32)
    qp[::4] = rp[src][::4]
    qc = rc[src].copy()
    qc[QT - 1::QT] = PAD_Q_CHARGE
    return q, qp, qc, r, rp, rc


# (W, starts, n_rows, rk, n_splits): identical and shifted starts, a partial
# last group (G + 1 tiles), ranges past n_rows, W = 7 (scalar loads) and 8.
CASES = [(8, [0, 0, 40, 64, 64, 100, 130, 200, 230], 300, 64, 2),
         (7, [0, 10, 10, 250, 270], 300, 64, 3)]


def check_design_against_reference(route, W, starts, n_rows, rk, n_splits, k, seed, *,
                                   lists="shared", query_words=None):
    """fused_by_design, the plain version and the reference's Pallas kernel
    (interpret mode; its MXU kernel for the +-1 route), bit for bit, on
    _case's data; returns the reference's outputs."""
    q, qp, qc, r, rp, rc = _case(seed, W, starts, n_rows, rk)
    got = fused_by_design(q, qp, qc, r, rp, rc, starts, rk=rk, dim=32 * W, k=k,
                          n_splits=n_splits, route=route, std_scale=href.std_scale(20.0),
                          open_tol=75.0, lists=lists, query_words=query_words)
    # The reference scans rows [s, s + rk) clipped to the DB, like the plain
    # version.
    mod = ref_hops if route == "binary" else ref_mops
    want = _reference(mod, q, r, qp, rp, qc, rc, starts, rk=rk, dim=32 * W, k=k)
    plain = href.fused_search(packed_to_torch(q), torch.from_numpy(qp),
                              torch.from_numpy(qc), packed_to_torch(r),
                              torch.from_numpy(rp), torch.from_numpy(rc),
                              torch.tensor(starts, dtype=torch.int32), q_block=QT,
                              rk=rk, dim=32 * W, k=k)
    assert int((want[3] >= 0).sum()) > 0 and int((want[1] >= 0).sum()) > 0
    for w, p, g in zip(want, plain, got):
        assert (w == p.numpy()).all()
        assert (w == g).all()
    return want


@pytest.mark.parametrize("route", ["binary", "pm1"])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("k", [1, 4])
def test_grouped_kernel_design_matches_reference_kernel(route, case, k):
    check_design_against_reference(route, *CASES[case], k, case * 10 + k)


@pytest.mark.parametrize("route", ["binary", "pm1"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_device_lists_match_reference_kernel(route, case):
    """The lists in device memory, one per (tile, list) for every split."""
    check_design_against_reference(route, *CASES[case], 4, case * 10 + 4, lists="global")


@pytest.mark.parametrize("route", ["binary", "pm1"])
def test_rows_past_the_old_shared_memory_bound_match_reference_kernel(route):
    """W = 2,496 words, past the old one-tile bound of both kernels (2,480
    and 2,416): device lists, queries staged in the launcher's chunks."""
    W = 2496
    plan = hops.fused_plan(W, 2, 4096 if route == "pm1" else 0)
    assert plan.lists == "global" and plan.query_words < W
    check_design_against_reference(route, W, [0, 20], 80, 32, 2, 2, 7, lists="global",
                                   query_words=plan.query_words)


PIPE_CFG = dict(dim=256, max_r=64, bin_size=0.2, encode_batch=64)


def test_pipeline_top_k_100_matches_reference():
    """OMSPipeline(backend="fused") at top_k = 100: all six SearchResult
    arrays and both FDR results equal the reference's."""
    ds = make_dataset(LibraryConfig(n_refs=240, n_queries=40, seed=1))
    refs, queries = (SpectraSet(*(np.array(x) for x in s)) for s in (ds.refs, ds.queries))
    want = ref_pipeline.OMSPipeline(ref_pipeline.OMSConfig(
        **PIPE_CFG, backend="fused", encode_backend="pallas"), ds.refs).search(
        ds.queries, top_k=100)
    pipe = pipeline.OMSPipeline(pipeline.OMSConfig(
        **PIPE_CFG, backend="fused", encode_backend="pallas"), refs, device="cpu")
    got = pipe.search(queries, top_k=100)
    res = convert.search_result_to_numpy(got.result)
    for f in want.result._fields:
        w = np.asarray(getattr(want.result, f))
        assert w.shape == res[f].shape and (w == res[f]).all(), f
    assert np.asarray(want.result.open_idx).shape[1] == 100
    for name in ("open_fdr", "std_fdr"):
        w, g = getattr(want, name), convert.fdr_result_to_numpy(getattr(got, name))
        for f in w._fields:
            assert (np.asarray(getattr(w, f)) == g[f]).all(), (name, f)

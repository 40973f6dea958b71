"""Roofline terms of the port's kernels on the NVIDIA H100 (SXM5, 80 GB).

Counterpart of both ``repro.utils.roofline`` and ``repro.utils.hlo_cost``.
The reference prices a compiled program by parsing XLA's optimised HLO
text; PyTorch has no such text, and ``torch.utils.flop_counter`` does not
see the kernels' ctypes launches. So the port's cost model is the
*analytic work of the function*: the operations it must do and the HBM
bytes it must move (each input read once, each output written once) —
the same whatever tiles, grids or splits implement it. ``chip_smoke.py``
and the tune sweep (:mod:`repro_torch.tune.sweep`) both read their bounds
from the work counts here.

Peaks (per card):
  * HBM3 bandwidth 3.35 TB/s — NVIDIA H100 Tensor Core GPU datasheet
    (SXM5);
  * dense int8 tensor-core rate 1,979 TOPS and bf16 989 TFLOP/s — the same
    datasheet (dense, without sparsity);
  * 64 32-bit integer add/logic results (LOP3 included) and 16 popc results
    per clock per SM — CUDA C++ Programming Guide, arithmetic instruction
    throughput, compute capability 9.0;
  * 0.589 ``mma.sync`` m16n8k256 b1 AND-popc instructions per clock per SM
    (16 x 8 pairs x 256 bits each) — measured by ``scripts/bmma_probe.py``
    on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md);
  * NVLink 450 GB/s per direction — the datasheet's 900 GB/s
    bidirectional;
  * 132 SMs at a 1,980 MHz maximum SM clock — the datasheet's SXM5 part,
    the default when the caller has not read the card's own clock.

Terms (seconds; ``flops`` here are the integer or tensor-core operations
of the route that does them, at ``ops_per_s``):
    compute    = flops      / (chips * ops_per_s)
    memory     = hbm_bytes  / (chips * HBM_BYTES_PER_S)
    collective = coll_bytes / (chips * NVLINK_BYTES_PER_S)
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
PEAK_FLOPS_BF16 = 989e12
INT32_OPS_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
BMMA_PER_CLK_SM = 0.589
BMMA_PAIR_BITS = 16 * 8 * 256
NVLINK_BYTES_PER_S = 450e9
H100_SMS = 132
H100_SM_CLOCK_HZ = 1.98e9


@dataclasses.dataclass
class Roofline:
    flops: float                 # operations of the route (see ops_per_s)
    hbm_bytes: float             # bytes the function must move
    coll_bytes: float            # summed collective operand bytes
    chips: int
    model_flops: float = 0.0     # analytic "useful" ops (2 * D per pair)
    ops_per_s: float = INT8_TENSOR_OPS_PER_S   # the route's peak rate
    route: str = ""              # which units the ops run on

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.ops_per_s)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BYTES_PER_S)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BYTES_PER_S)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-model time (no overlap assumption = max)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bound_by(self) -> str:
        """``"operations"`` or ``"bytes"``, as the kernels JSON line says."""
        return "operations" if self.t_compute >= self.t_memory else "bytes"

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ideal (useful-ops-only) time at the route's rate:
        how close the function is to the pure-compute roofline."""
        ideal = self.model_flops / (self.chips * self.ops_per_s)
        return ideal / self.t_bound if self.t_bound > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops, "ops_per_s": self.ops_per_s,
            "route": self.route,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_fraction": self.roofline_fraction,
        }


def useful_ops(dim: int, q_rows: int, r_rows: int) -> float:
    """Analytic "useful" work of one all-pairs scan: 2 * D ops per (query,
    reference) pair (the +-1 dot formulation)."""
    return 2.0 * dim * q_rows * r_rows


def hamming_routes(pairs: float, n_words: int, dim: int, *,
                   clock_hz: float = H100_SM_CLOCK_HZ,
                   n_sms: int = H100_SMS) -> dict[str, tuple[float, float]]:
    """The three routes to ``pairs`` Hamming distances of ``n_words`` words:
    route -> (operations, operations per second) — a popc per (pair,
    word); 2 * dim int8 tensor-core ops per pair (a +-1 dot); or one
    m16n8k256 AND-popc MMA per 16 x 8 pairs x 256 bits on the binary
    tensor cores, at the rate the probe measured."""
    return {
        "popc": (pairs * n_words, POPC_PER_CLK_SM * n_sms * clock_hz),
        "int8 tensor cores": (pairs * dim * 2.0, INT8_TENSOR_OPS_PER_S),
        "binary tensor cores": (pairs * 32 * n_words / BMMA_PAIR_BITS,
                                BMMA_PER_CLK_SM * n_sms * clock_hz),
    }


def _cheapest(routes: dict, names) -> tuple[str, float, float]:
    name = min(names, key=lambda n: routes[n][0] / routes[n][1])
    return name, *routes[name]


def tile_roofline(q_rows: int, r_rows: int, n_words: int, dim: int, *,
                  clock_hz: float = H100_SM_CLOCK_HZ,
                  n_sms: int = H100_SMS) -> Roofline:
    """All-pairs (Q, R) Hamming tile (``hamming_matrix``, ``hamming_mxu``):
    the rows and queries read once, the int32 tile written once; the
    operations by the cheaper of popc and the int8 +-1 dot."""
    pairs = float(q_rows) * r_rows
    route, ops, rate = _cheapest(
        hamming_routes(pairs, n_words, dim, clock_hz=clock_hz, n_sms=n_sms),
        ("popc", "int8 tensor cores"))
    nbytes = (r_rows * n_words + q_rows * n_words + q_rows * r_rows) * 4
    return Roofline(flops=ops, hbm_bytes=nbytes, coll_bytes=0.0, chips=1,
                    model_flops=useful_ops(dim, q_rows, r_rows),
                    ops_per_s=rate, route=route)


def fused_roofline(n_queries: int, rk: int, covered_rows: int, n_words: int,
                   dim: int, k: int, n_blocks: int, *,
                   clock_hz: float = H100_SM_CLOCK_HZ,
                   n_sms: int = H100_SMS) -> Roofline:
    """Fused dual-window top-k of ``n_queries`` sorted/padded queries, each
    block scanning ``rk`` rows: the ``covered_rows`` distinct rows the
    blocks scan read once (words, pmz, charge), the queries and their
    sidecars, the ``n_blocks`` start rows, four (Q, k) int32 outputs; the
    operations by the cheapest of the three Hamming routes."""
    pairs = float(n_queries) * rk
    route, ops, rate = _cheapest(
        hamming_routes(pairs, n_words, dim, clock_hz=clock_hz, n_sms=n_sms),
        ("popc", "int8 tensor cores", "binary tensor cores"))
    nbytes = (covered_rows * (n_words * 4 + 8) + n_queries * n_words * 4
              + n_queries * 8 + n_blocks * 4 + 4 * n_queries * k * 4)
    return Roofline(flops=ops, hbm_bytes=nbytes, coll_bytes=0.0, chips=1,
                    model_flops=useful_ops(dim, n_queries, rk),
                    ops_per_s=rate, route=route)


def hdencode_roofline(n_spectra: int, n_peaks: int, n_words: int,
                      n_valid: int, touched_rows: int, *,
                      clock_hz: float = H100_SM_CLOCK_HZ,
                      n_sms: int = H100_SMS) -> Roofline:
    """ID-level encode of ``n_spectra`` x ``n_peaks`` peaks (``n_valid``
    valid) into ``n_words``-word HVs. Per (valid peak, word): one XOR to
    bind and a carry-save add into a bit-sliced counter (~2 LOP3s); per
    output word the majority compare of a ceil(log2(P+1))-plane count
    (~2 ops a plane) and the tie-break select. Bytes: bins, levels and mask
    (9 bytes a peak), the ``touched_rows`` codebook rows, the tiebreak
    word row, the output."""
    planes = max(1, int(n_peaks).bit_length())
    ops = n_valid * n_words * 3 + n_spectra * n_words * (2 * planes + 1)
    nbytes = (n_spectra * n_peaks * 9 + touched_rows * n_words * 4
              + n_words * 4 + n_spectra * n_words * 4)
    return Roofline(flops=ops, hbm_bytes=nbytes, coll_bytes=0.0, chips=1,
                    ops_per_s=INT32_OPS_PER_CLK_SM * n_sms * clock_hz,
                    route="int32 ALU")

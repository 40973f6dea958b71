"""Probe the tensor-core MMA shapes a packed Hamming tile can use on Hopper.

    python3 scripts/bmma_probe.py

Builds ``scripts/bmma_probe.cu`` once per variant for ``sm_90a`` (the
binary ``m16n8k256`` MMA with ``.and.popc`` and with ``.xor.popc``, and the
int8 ``m16n8k32`` MMA for comparison), and for each variant that ptxas
accepts: prints what ptxas said (warnings included), checks one MMA on
random words against numpy in the word map of
``src/repro_torch/kernels/hamming/csrc/hamming_matrix.cu``, and times the
instruction rate (CUDA events, median of 10) with every SM full of warps
running independent MMAs, and again in the fused search kernels' shape
(one CTA of 8 warps per SM, 32 accumulators a warp, A read from shared
memory; for the int8 MMA also with every B operand made from a packed word
by the nibble expansion of fused_search_mxu.cu, by a shift and an AND per
register (0/1 bytes), and by one AND per register, the 0 / 2^p bytes of
hamming_mxu.cu); and, for the int8 MMA, in hamming_mxu.cu's shape (one
CTA of 8 warps per SM, one query tile, 4 n8 tiles, 8 accumulators a warp,
each MMA's B operand made from a packed word of its own, by the same
three expansions). Needs a GPU and ``nvcc``; the libraries
go to ``build/bmma_probe/`` (git-ignored). The last line is one JSON
object.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

VARIANTS = {0: "b1.and.popc m16n8k256", 1: "b1.xor.popc m16n8k256",
            2: "s8 m16n8k32"}
K_BITS = {0: 256, 1: 256, 2: 32}     # multiply-adds per output element
THREADS = 256
ITERS = 4096
# probe_fused_rate's `expand`: how each int8 B register comes from a packed
# word (bmma_probe.cu b_operand).
EXPANDS = (0, 1, 2, 3)
EXPAND_KEYS = {0: "", 1: "_b_expanded", 2: "_b_shift_and", 3: "_b_and"}
EXPAND_NAMES = {0: "", 1: ", B +-1 nibble expansion (~5 instructions a register)",
                2: ", B 0/1 bytes (shift + AND a register)",
                3: ", B 0 / 2^p bytes (one AND a register)"}


def build(variant: int, out_dir: Path):
    lib = out_dir / f"libbmma_probe_{variant}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
           f"-DPROBE_VARIANT={variant}", "-o", str(lib), str(HERE / "bmma_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, (proc.stdout + proc.stderr).strip(), lib


def host_tile(variant: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(16, 8) words x (8, 8) words -> (16, 8) int32, as the MMA computes."""
    if variant == 2:
        a8 = a.view(np.int8).reshape(16, 32).astype(np.int64)
        b8 = b.view(np.int8).reshape(8, 32).astype(np.int64)
        return (a8 @ b8.T).astype(np.int32)
    op = np.bitwise_and if variant == 0 else np.bitwise_xor
    x = op(a[:, None, :], b[None, :, :])
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int32)


def median_ms(run) -> float:
    """Median milliseconds of run() over 10 CUDA-event-timed calls, after one."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("no GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    clk_hz = float(clock.split()[0]) * 1e6
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out_dir = ROOT / "build" / "bmma_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    results = {}
    for v, name in VARIANTS.items():
        rc, log, path = build(v, out_dir)
        warn = [line for line in log.splitlines()
                if "warn" in line.lower() or "deprecat" in line.lower()
                or "error" in line.lower()]
        print(f"[probe] {name}: nvcc exit {rc}")
        for line in log.splitlines():
            print(f"[probe]   {line}")
        res = {"accepted": rc == 0, "warnings": warn}
        results[name] = res
        if rc != 0:
            continue
        lib = ctypes.CDLL(str(path))
        lib.probe_tile.argtypes = [ctypes.c_void_p] * 3
        lib.probe_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.probe_fused_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.probe_tile_rate.argtypes = lib.probe_fused_rate.argtypes
        ok = True
        for _ in range(4):
            a = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint64).astype(np.uint32)
            b = rng.integers(0, 2 ** 32, (8, 8), dtype=np.uint64).astype(np.uint32)
            ta = torch.from_numpy(a.view(np.int32)).to(dev)
            tb = torch.from_numpy(b.view(np.int32)).to(dev)
            td = torch.zeros((16, 8), dtype=torch.int32, device=dev)
            if lib.probe_tile(ta.data_ptr(), tb.data_ptr(), td.data_ptr()):
                raise RuntimeError(f"{name}: probe_tile launch failed")
            torch.cuda.synchronize()
            ok &= bool((td.cpu().numpy() == host_tile(v, a, b)).all())
        res["tile_matches_numpy"] = ok
        blocks = n_sms * 8
        out = torch.empty(blocks * THREADS, dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run():
            if lib.probe_rate(out.data_ptr(), blocks, THREADS, ITERS, stream):
                raise RuntimeError(f"{name}: probe_rate launch failed")
        ms = median_ms(run)
        n_mma = blocks * (THREADS // 32) * ITERS * 8   # probe_chains() == 8
        res["ms"] = ms
        res["mma_per_s"] = n_mma / (ms * 1e-3)
        res["mma_per_clk_per_sm"] = n_mma / (ms * 1e-3) / clk_hz / n_sms
        # 16 x 8 outputs, each a K-long multiply-add (or AND/XOR + popc) sum
        res["tera_ops_per_s"] = n_mma * 16 * 8 * K_BITS[v] * 2 / (ms * 1e-3) / 1e12
        print(f"[probe] {name}: tile == numpy: {ok}; {ms:.3f} ms for {n_mma} MMAs: "
              f"{res['mma_per_clk_per_sm']:.3f} per clock per SM, "
              f"{res['tera_ops_per_s']:.1f} T bit/byte-ops/s")
        # The fused kernels' shape: n_sms CTAs of 8 warps, 32 MMAs a round.
        fused_out = torch.empty(n_sms * THREADS, dtype=torch.int32, device=dev)
        for expand in (EXPANDS if v == 2 else (0,)):
            def fused_run(expand=expand):
                if lib.probe_fused_rate(fused_out.data_ptr(), n_sms, ITERS, expand, stream):
                    raise RuntimeError(f"{name}: probe_fused_rate launch failed")
            fused_ms = median_ms(fused_run)
            n_fused = n_sms * (THREADS // 32) * ITERS * 32
            key = "fused_shape" + EXPAND_KEYS[expand]
            res[key + "_mma_per_clk_per_sm"] = n_fused / (fused_ms * 1e-3) / clk_hz / n_sms
            print(f"[probe] {name}, fused kernels' shape (8 warps/SM, 32 accumulators"
                  f"{EXPAND_NAMES[expand]}): "
                  f"{res[key + '_mma_per_clk_per_sm']:.3f} per clock per SM")
        # hamming_mxu.cu's shape: n_sms CTAs of 8 warps, 64 MMAs a round.
        for expand in (EXPANDS if v == 2 else ()):
            def tile_run(expand=expand):
                if lib.probe_tile_rate(fused_out.data_ptr(), n_sms, ITERS, expand, stream):
                    raise RuntimeError(f"{name}: probe_tile_rate launch failed")
            tile_ms = median_ms(tile_run)
            n_tile = n_sms * (THREADS // 32) * ITERS * 64
            key = "mxu_tile_shape" + EXPAND_KEYS[expand]
            res[key + "_mma_per_clk_per_sm"] = n_tile / (tile_ms * 1e-3) / clk_hz / n_sms
            print(f"[probe] {name}, hamming_mxu's shape (8 warps/SM, 8 accumulators, a "
                  f"packed word per MMA{EXPAND_NAMES[expand]}): "
                  f"{res[key + '_mma_per_clk_per_sm']:.3f} per clock per SM")
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "max_sm_clock": clock, "n_sms": n_sms, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

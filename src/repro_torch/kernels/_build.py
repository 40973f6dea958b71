"""Build and load the port's CUDA kernels (nvcc -> one shared library).

Every ``**/csrc/*.cu`` under ``repro_torch/kernels`` exposes a plain C
interface; device code shared between kernels lives in headers (``*.cuh``,
``*.h``) under the same ``csrc/`` directories. On first use the sources are
compiled for ``sm_90a`` — one ``nvcc -c`` per source, all started together
— and linked into one shared library, which is loaded with ``ctypes``. The
library lands in ``<checkout>/build/kernels/<hash>/`` (git-ignored), keyed
by a hash of the sources, the headers and the flags, so an edited source or
header rebuilds and an unchanged tree is reused. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = _KERNELS_DIR.parents[2] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# Kernel builds started by this process (``build`` compiling, not reusing a
# finished library); the analyzer's recompile_guard reads it.
builds = 0
# The op recorder of ``repro_torch.analysis.op_walk`` while one is active:
# a kernel wrapper call then shows to it as one op (see ``kernel_op``).
region_hook = None


def kernel_op(name: str):
    """Decorator of a kernel wrapper: while an op recorder is active, the
    call is one recorded op named ``name`` whose outputs are the wrapper's
    outputs — on the CPU the plain version's own tiles stay inside it, as a
    Pallas kernel's VMEM tiles stay inside its ``pallas_call``. Without a
    recorder it adds nothing to the call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            hook = region_hook
            if hook is None:
                return fn(*args, **kwargs)
            return hook.kernel_call(name, fn, args, kwargs)
        return wrapper
    return deco


class LaunchCounter:
    """Plain launch count of one kernel wrapper: the wrapper adds one where
    it launches its kernel and nowhere else."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def sources() -> list[Path]:
    return sorted(_KERNELS_DIR.glob("**/csrc/*.cu"))


def headers() -> list[Path]:
    return sorted(p for ext in ("cuh", "h")
                  for p in _KERNELS_DIR.glob(f"**/csrc/*.{ext}"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME)")


def _digest() -> str:
    """Hash of the flags and of every source and header, by relative path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(sources() + headers()):
        h.update(p.relative_to(_KERNELS_DIR).as_posix().encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(log=None) -> Path:
    """Compile every kernel source (in parallel) and link the shared library;
    returns its path. A finished build is reused. ``log`` receives nvcc's
    output (register and shared-memory use from ``-Xptxas -v``)."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    global builds
    builds += 1
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    # Build in a private directory and move the library into place with one
    # atomic rename, so a concurrent build never loads a half-written file.
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if log is not None and out:
                log(f"[nvcc {src.name}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp / LIB_NAME),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
    # bins, levels, mask, id_hvs, level_hvs, tiebreak, out, B, P, W, stream
    "hdencode_launch": ([_P] * 7 + [_I] * 3 + [_P], _I),
    # q, q_pmz, q_charge, r, r_pmz, r_charge, tile_start, partial, 4 outputs,
    # n_tiles, n_rows, W, dim, k, rk, n_splits, std_scale, open_tol,
    # pad_pmz, stream
    "fused_search_launch": ([_P] * 12 + [_I] * 7 + [_F] * 3 + [_P], _I),
    # the same arguments; requires dim == 32 * W
    "fused_search_mxu_launch": ([_P] * 12 + [_I] * 7 + [_F] * 3 + [_P], _I),
    # q, r, out, Q, R, W, ctas_per_sm, stream
    "hamming_matrix_launch": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # q, r, out, Q, R, W, dim, ctas_per_sm, stream
    "hamming_mxu_launch": ([_P] * 3 + [_I] * 5 + [_P], _I),
    # qp, qc, kmin, kmax, out, Q, n_blocks, q_block, open_tol, stream
    "plan_reach_launch": ([_P] * 5 + [_I] * 3 + [_F, _P], _I),
}


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device`` — what a launcher's raw pointer assumes."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be a {ndim}-d {dtype} tensor, "
                         f"got {t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def on_device(device: torch.device):
    """Guard of one kernel launch: makes ``device``, the device of the
    launch's tensors, the current CUDA device for the call. The launchers
    read the current device where they take its SM count and where they
    opt in to more than 48 KB of dynamic shared memory
    (``cudaFuncSetAttribute``), so without it a launch on a second card
    would run with the first card's settings."""
    return torch.cuda.device(device)

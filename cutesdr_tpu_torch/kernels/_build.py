"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` (one process per source,
all started together) and link into ONE shared library with a plain C
interface, loaded with ``ctypes``.  The build happens at first use, never
at import, into ``<repo>/build/kernels/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a fresh
checkout builds from its own sources alone.  No ``--use_fast_math``: the
mixdec oscillator needs the accurate ``sincosf``.

Every C entry point enqueues its kernels on the caller's stream and
returns ``cudaGetLastError()``; ``check`` raises on anything but 0.

The first ``library()`` of a process (the hash, the build where it is
missing, the load) is the set-up span ``setup.kernels``, and
``metrics.COUNTERS["setup.kernels_built"]`` is 1 where it compiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from cutesdr_tpu_torch import metrics

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libcutesdr_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
U32 = ctypes.c_uint32
F32 = ctypes.c_float

# C signatures: name -> argument types (every entry returns a cudaError_t)
SIGNATURES = {
    # re, im, re_cstride, im_cstride, re_stride, im_stride, tail, tail_len,
    # tail_cstride, taps, ntaps, dc, phase, incs, inc0, scale, dec, n_out,
    # n_ch, tile_out, threads, y, stream
    "cutesdr_mixdec": [P, P, I64, I64, I64, I64, P, I32, I64, P, I32, P, P,
                       P, U32, F32, I32, I32, I32, I32, I32, P, P],
    # the same, over int16 planes
    "cutesdr_mixdec_i16": [P, P, I64, I64, I64, I64, P, I32, I64, P, I32, P,
                           P, P, U32, F32, I32, I32, I32, I32, I32, P, P],
    # tail, block, h, twiddles, y, nfft, ntaps, n_frames, n_ch,
    # frames_per_block, tail_cstride, block_cstride, h_cstride, y_cstride,
    # stream
    "cutesdr_fastfir": [P, P, P, P, P, I32, I32, I32, I32, I32, I64, I64,
                        I64, I64, P],
    # a, a_scalar, b, b_scale, x0, x0_stride, x0_value, n, rows, vec, x,
    # flags, agg, ticket, stream
    "cutesdr_scan_affine": [P, F32, P, F32, P, I32, F32, I32, I32, I32, P,
                            P, P, P, P],
    # peak, pattern_in, rise, fall, ag, x0, n, rows, n_iters, x, pattern,
    # counts, rounds, ok, totals_a, totals_b, done, tally, stream
    "cutesdr_scan_solve": [P, P, F32, F32, F32, P, I32, I32, I32, P, P, P, P,
                           P, P, P, P, P, P],
    # peak, d0, timer0, rise, fall, hang_time, n, rows, n_iters, d, timer,
    # pattern, counts, rounds, ok, last, carry, agg, done, stream
    "cutesdr_hang_solve": [P, P, P, F32, F32, I32, I32, I32, I32, P, P, P, P,
                           P, P, P, P, P, P, P],
    # mag, aa, 1 - aa, ad, 1 - ad, a0, d0, carry_stride, n, rows, vec, out,
    # flags, agg, ticket, stream
    "cutesdr_smeter": [P, F32, F32, F32, F32, P, P, I32, I32, I32, I32, P, P,
                       P, P, P],
    # peak, n, n_ch, attack rise, attack fall, decay rise, decay fall,
    # hang_time, a0, d0, timer0, a_out, d_out, timer_out, mag, skip, count,
    # stream
    "cutesdr_agc_seq": [P, I32, I32, F32, F32, F32, F32, I32, P, P, P, P, P,
                        P, P, P, P, P],
    # x, a1, a2, b0, b1, b2, w1, w2, n, rows, vec, y, w_out, flags, agg,
    # ticket, stream
    "cutesdr_biquad": [P, F32, F32, F32, F32, F32, P, P, I32, I32, I32, P, P,
                       P, P, P, P],
    # theta, n, n_ch, alpha, beta, limit, fast, halo, state0, freqs, err,
    # state, valid, e1, e2, flags, ticket, clocks, stager_ns, skip, stream
    "cutesdr_fm_pll": [P, I32, I32, F32, F32, F32, I32, I32, P, P, P, P, P,
                       P, P, P, P, P, U32, P, P],
    # theta, n, n_ch, alpha, beta, limit, fast, state0, prev, state,
    # clocks, skip, stream
    "cutesdr_sam_pll": [P, I32, I32, F32, F32, F32, I32, P, P, P, P, P, P],
    # zr, zi, z_cstride, es, nz, t_int, t_frac, t_cstride, n_out, tables,
    # M, periods, interp, lanes, outputs_per_block, taps_per_lane, span,
    # n_streams, yr, yi, y_cstride, ys, stream
    "cutesdr_resamp": [P, P, I64, I32, I32, P, P, I64, I32, P, I32, I32, I32,
                       I32, I32, I32, I32, I32, P, P, I64, I32, P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the first failure's output
    once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the library if this source hash has not been built yet: one
    nvcc per source, all at once, then one link."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    obj_dir = out_dir / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [str(obj_dir / (p.stem + ".o")) for p in cus]
    nvcc = _nvcc()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
              for p, o in zip(cus, objs)])
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]])
    os.replace(tmp, lib)
    shutil.rmtree(obj_dir, ignore_errors=True)
    metrics.count("setup.kernels_built")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            with metrics.span("setup.kernels"):
                lib = ctypes.CDLL(str(build()))
                for name, args in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (the kernels' plans
    spread their blocks over them)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            numel: int | None = None, contiguous: bool = True,
            rows: int | None = None) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype``: 1-D (of ``numel``
    elements), or with ``rows`` 2-D of [rows, numel]."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if rows is None:
        if t.dim() > 1:
            raise ValueError(f"{name}: expected a 1-D tensor, got "
                             f"{tuple(t.shape)}")
        if numel is not None and t.numel() != numel:
            raise ValueError(f"{name}: expected {numel} elements, got "
                             f"{t.numel()}")
    elif t.dim() != 2 or t.shape[0] != rows or \
            (numel is not None and t.shape[1] != numel):
        raise ValueError(f"{name}: expected [{rows}, {numel}], got "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cpu(*ts: torch.Tensor) -> bool:
    """Device rule of every wrapper: CPU tensors take the plain version,
    CUDA tensors the kernel, anything else (or a mix) raises."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on unsupported devices {sorted(kinds)}")

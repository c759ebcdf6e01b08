"""Build and load the port's CUDA kernels (csrc/*.cu -> one shared library).

The kernels are compiled with nvcc for sm_90a into ``build/kernels/`` at the
repository root, at first use, and bound with ctypes: each ``extern "C"``
launcher takes device pointers and the stream as ``c_void_p`` and returns a
cudaError_t code. Each source is compiled to an object by its own nvcc, all
started together, and the objects are linked into one library. The
library's file name carries a hash of the sources and the headers they
include, so an edited source or header is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("composite_sky.cu", "attention.cu", "attention_bf16.cu", "gather.cu", "hash_encode.cu",
           "splat_raster.cu")
HEADERS = ("attention_common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # alpha, feats, w_sky, features, accum, R, S, C, stream
    "composite_sky_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # alpha, feats, dwsky, df, daccum, dalpha, dfeats, R, S, C, stream (the float4 path, and the general one)
    "composite_sky_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "composite_sky_bwd_general": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # alpha, feats, steps, weights, features, depth, accum, R, S, C, stream
    "composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # table, idx, out, flag, T, N, F, stream
    "row_gather": [_P, _P, _P, _P, _I, _I, _I, _P],
    # q, k, v, out, lse, B, S, D, scale, seed, thresh, inv_keep, stream
    "self_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _U, _U, _F, _P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, D, scale, seed, thresh, inv_keep, stream
    "self_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _U, _U, _F, _P],
    # q, k, v, out, out32, lse, B, S, D, scale, seed, thresh, inv_keep, stream (bf16 q, k, v, out)
    "self_attention_bf16_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _U, _U, _F, _P],
    # q, k, v, out32, dout, lse, scratch, dq, dk, dv, B, S, D, scale, seed, thresh, inv_keep, stream
    "self_attention_bf16_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _U, _U, _F, _P],
    # pos, table, table_bf16, out, scalings (a host array), N, D, L, F, T, stream
    "hash_encode_fwd": [_P, _P, _I, _P, _FP, _L, _I, _I, _I, _L, _P],
    # pos, table, table_bf16, grad_out, scalings, N, D, L, F, T, l0, l1, acc, table_grad, pos_acc, pos_grad,
    # first, last, stream
    "hash_encode_bwd": [_P, _P, _I, _P, _FP, _L, _I, _I, _I, _L, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    # feats, radius, in_view, G, tw, th, tile_r, counts, tile_counts, stream
    "splat_bin_count": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    # feats, radius, in_view, ends, counts, G, tw, th, tile_r, keys, gids, stream
    "splat_bin_emit": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    # feats, gids, tile_start, tile_counts, T, K, tw, out_w, out_h, color, alpha, depth, stream
    "splat_raster_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # feats, gids, tile_start, tile_counts, T, K, tw, out_w, out_h, color, alpha, depth, dcolor, dalpha,
    # ddepth, dfeats, stream
    "splat_raster_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # B, S -> the float32 scratch self_attention_bf16_bwd takes
    "self_attention_bf16_bwd_scratch": [_I, _I],
}
_RESTYPES = {"self_attention_bf16_bwd_scratch": ctypes.c_longlong}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libneuradar_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> list:
    """Start every command at once, wait for all; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    logs = [p.communicate() for p in procs]
    for p, (_, err) in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err}")
    return [err for _, err in logs]


def build(verbose: bool = False) -> Path:
    """Compile the sources if this version of them is not built yet; return the library path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build to private names and rename: concurrent builders never see a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        logs = _run_all([[nvcc, *COMPILE_FLAGS, *ptxas, "-I", str(CSRC), "-c", "-o", o, str(CSRC / s)]
                         for s, o in zip(SOURCES, objs)])
        out = str(Path(tmp) / lib.name)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs]])
        if verbose:
            print("".join(logs), end="")
        os.replace(out, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _bind(lib)
        _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """The port's signatures for the launchers ``lib`` exports."""
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)


def build_each(sources: dict, out_dir: Path) -> dict:
    """Each source (name -> path) alone into its own library under ``out_dir`` (one nvcc each, all
    started together), loaded and bound with the port's signatures for the launchers it exports.
    A source may include the port's headers (``csrc/`` is on the include path). For measurements
    that set variants of a kernel side by side; the port loads ``load()`` only."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths = {name: out_dir / f"lib{name}.so" for name in sources}
    _run_all([[nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-shared", "-o", str(paths[name]), str(src)]
              for name, src in sources.items()])
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        libs[name] = lib
    return libs


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")

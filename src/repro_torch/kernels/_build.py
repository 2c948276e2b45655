"""Build and load the hand-written Hopper kernels (plain C interface + ctypes).

Every ``csrc/*.cu`` file becomes one shared library, compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``) at first use.  A library's file name carries a hash of all
of ``csrc/`` and the flags, so a changed source rebuilds and an unchanged one
is loaded as it is.  ``build_all`` starts one ``nvcc`` per source at once.

Each C entry point takes its tensors and the CUDA stream as ``void*``
(``ctypes.c_void_p``), launches without synchronising and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.

``LAUNCHES`` counts kernel launches by kernel name.  A wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

LAUNCHES: dict[str, int] = {"unpack_blocks": 0, "gallop_tiles": 0,
                            "gallop_tiles_batched": 0,
                            "packed_gallop_batched": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> (library stem, argtypes)
SIGNATURES = {
    # words, T, offsets, widths, seeds, K, block_rows, mode, out, stream
    "repro_unpack_blocks": ("unpack_blocks",
                            [_P, _I, _P, _P, _P, _I, _I, _I, _P, _P]),
    # r, B, M, f, N, out, stream
    "repro_gallop_tiles": ("gallop_tiles", [_P, _I, _I, _P, _I, _P, _P]),
    # r, M, words, Tp, widths, offsets, maxes, Kp, blk, C, exc_pos, exc_add,
    # E, block_rows, mode, B, window, out, stream
    "repro_packed_gallop": ("packed_gallop",
                            [_P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                             _I, _I, _I, _I, _P, _P, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest()}.so"


def build_all() -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once.
    Returns stem → library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stems = sorted({stem for stem, _ in SIGNATURES.values()})
    paths = {s: lib_path(s) for s in stems}
    procs = []
    for stem, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for stem, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu:\n{log.decode()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def function(name: str):
    """The C entry ``name`` with its argtypes set (builds on first use)."""
    stem, argtypes = SIGNATURES[name]
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = lib_path(stem)
            if not path.exists():
                build_all()
            lib = _libs[stem] = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")


def count(name: str) -> None:
    LAUNCHES[name] += 1


def kernel_path(*tensors: torch.Tensor) -> bool:
    """The path probe: True when the tensors lie on a CUDA device of compute
    capability ≥ (9, 0), so the hand kernels run; False on the CPU, where the
    plain versions run.  A CUDA device below sm_90, another device type, or
    tensors on different devices raise: a tensor on the card reaches a
    kernel or an error, never the plain version."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"no kernels for device type {dev.type!r}")
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; {dev} has "
                           f"compute capability {cap[0]}.{cap[1]}")
    return True


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is what a kernel takes: dtype, rank, contiguity."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype} tensor, "
                         f"got {t.dtype} of shape {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream

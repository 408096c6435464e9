"""Build and load the port's hand-written CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, and loaded with
``ctypes``.  The build happens at first use, never at import: the CPU tests
import every module on machines without ``nvcc``.  Libraries land in
``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a hash of
all the sources and the flags, so an edited source rebuilds and an unchanged
checkout reuses what it built.  All sources compile in parallel, one
``nvcc`` each.

Each exported C function launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; :func:`check` raises on a non-zero
code (a launch refused for its shared memory or grid never runs, and only
this check shows it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet (all in parallel);
    returns ``{stem: library path}``.  Raises with nvcc's output on
    failure; ptxas's register and shared-memory report lands beside each
    library as ``<stem>.ptxas.txt``."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in _sources()}
    procs = []
    for src in _sources():
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, lib, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        (out_dir / f"{src.stem}.ptxas.txt").write_text(log)
        os.replace(tmp, lib)        # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    with _LOCK:
        if stem not in _LIBS:
            libs = build_all()
            _LIBS[stem] = ctypes.CDLL(str(libs[stem]))
        return _LIBS[stem]


def function(stem: str, name: str, n_ptr: int, n_int: int):
    """The C function ``name`` of ``csrc/<stem>.cu`` that takes ``n_ptr``
    pointers, ``n_int`` ints and the stream; its argtypes are set once."""
    key = (stem, name)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(stem), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> ctypes.c_void_p:
    """``t``'s device address for a launch.  Raises on a tensor subclass
    (a ``DTensor``, a fake tensor): its data is not one plain buffer that
    a kernel could read."""
    import torch
    if type(t) not in (torch.Tensor, torch.nn.Parameter):
        raise TypeError(f"a kernel takes plain tensors, got "
                        f"{type(t).__name__}")
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]

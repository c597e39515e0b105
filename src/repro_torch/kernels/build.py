"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
at first use, under ``kernels/_build/`` (git-ignored), keyed by a hash of
the source, the ``csrc/*.cuh`` headers it includes and the flags, so an
edited source or header rebuilds and an unchanged one loads from the cache.
``build_all`` starts one ``nvcc`` per source at once.  Nothing here runs at
import time: the CPU tests import this module on machines without
``nvcc``.

Flags: fast math stays off everywhere (IEEE division, accurate ``expf``).
The update kernels also take ``-fmad=false``, which keeps every multiply
and add separately rounded (no FMA contraction), so they are bitwise their
plain PyTorch versions (``kernels/torch_update``).  ``flash_attention`` and
``ssd_scan`` are held to a tolerance, not bitwise: their matrix products
run on the tensor cores, fp32 operands split into two TF32 parts so that
the products stay fp32-accurate (``csrc/split_mma.cuh``), and their
CUDA-core arithmetic may contract into FMAs (``SOURCE_FLAGS``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("vrl_update", "comm_update", "leaf_update", "flash_attention",
           "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# per source, after NVCC_FLAGS: the bitwise update kernels contract nothing
SOURCE_FLAGS = {"vrl_update": ("-fmad=false",),
                "comm_update": ("-fmad=false",),
                "leaf_update": ("-fmad=false",),
                "flash_attention": (),
                "ssd_scan": ()}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def flags(name: str) -> tuple:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+\.cuh)"', re.M)


def headers(name: str) -> list:
    """The ``csrc/*.cuh`` headers that ``csrc/<name>.cu`` includes, in
    sorted order."""
    src = (CSRC / f"{name}.cu").read_bytes()
    return sorted(CSRC / m.decode() for m in set(_INCLUDE.findall(src)))


def library_path(name: str) -> Path:
    """The cached library of ``csrc/<name>.cu``: keyed by the source, the
    headers it includes (name and bytes) and the flags."""
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in headers(name):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def _compile(names: Iterable[str]) -> None:
    """Start one nvcc per stale library, all at once; wait for all."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)        # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> None:
    """Compile every stale kernel library in parallel."""
    with _lock:
        _compile(SOURCES)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib

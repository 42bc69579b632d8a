"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is a self-contained source with a plain C
interface. At first use it is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout (git-ignored), and
loaded with ``ctypes``. The library's file name carries a hash of the
source and the flags, so a library is rebuilt exactly when its source
changes. A failed build raises with nvcc's output; nothing falls back.

``build_all()`` starts one ``nvcc`` per source at once and waits for
all of them, so the build time is that of the slowest source.
``tensor_core_ops(name)`` reads the built library's SASS (``cuobjdump``)
and counts each kernel's tensor-core instructions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_LOGS: dict = {}          # source name -> nvcc/ptxas output of its build
_LOCK = threading.Lock()


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``. Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "repro_torch cannot be built on this host")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _wait(name: str, started) -> str:
    """Wait for one nvcc; install its library and return "" on success,
    else remove the partial output and return the error text."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"nvcc failed to build {name}.cu (exit {proc.returncode}):"
                f"\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent builder sees all or none
    return ""


def build_all() -> float:
    """Build every source that is not built yet, all nvcc processes at
    once; waits for every one of them, then raises if any failed.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _LOCK:
        started = {n: _start(n) for n in sources()}
        errors = [_wait(n, s) for n, s in started.items() if s is not None]
    errors = [e for e in errors if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed. Cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        err = _wait(name, started) if started is not None else ""
        if err:
            raise RuntimeError(err)
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def tensor_core_ops(name: str) -> dict:
    """{kernel: number of tensor-core instructions (HMMA, HGMMA)} in the
    SASS of the built ``csrc/<name>.cu`` (``cuobjdump -sass``, from the
    toolkit of ``nvcc_path()``), one entry per kernel instantiation,
    named ``kernel<template arguments>`` as the mangled name gives them.
    Builds the library first if needed."""
    load(name)
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _kernel_label(line.split("Function :", 1)[1].strip())
            counts[kernel] = 0
        elif kernel is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[kernel] += 1
    return counts


def _kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled ``..._kernel<...>`` template
    instantiation (``flash_wgmma_kernel<128>``,
    ``flash_split_kernel<bf16,128>``); the mangled name otherwise."""
    end = mangled.find("_kernelI") + len("_kernel")
    if end < len("_kernel"):
        return mangled
    for size in range(1, end):        # the identifier's length prefix
        start = end - size
        if mangled[:start].endswith(str(size)):
            break
    else:
        return mangled
    args = mangled[end + 1:mangled.find("EE", end) + 1]
    args = re.sub(r"Li(\d+)E", r"\1,", args)
    args = re.sub(r"^f", "float,", args.replace("13__nv_bfloat16", "bf16,"))
    return f"{mangled[start:end]}<{args.rstrip(',')}>"

"""Build and load the port's CUDA kernels as one shared library.

Every ``csrc/*.cu`` source compiles in its own ``nvcc`` process (all
started together), then one link step writes
``build/kernels/librepro_torch_kernels.so`` at the repository root.  The
build runs at first use and is keyed on a sha256 of the sources: a
library built from other sources is rebuilt, an up-to-date one is only
loaded.  The entry points have a plain C interface (device pointers,
sizes, the CUDA stream) and return ``cudaGetLastError()``; they are
bound with ``ctypes``, so the build never includes PyTorch's headers.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from repro_torch.device import nvcc_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(_PKG))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash(paths: Sequence[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


class KernelLibrary:
    """The loaded library of one process, built on first ``get()``."""

    def __init__(self, build_dir: str = BUILD_DIR):
        self.build_dir = build_dir
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None     # guarded_by: self._lock
        self._fns: Dict[str, object] = {}           # guarded_by: self._lock
        self.built = False      # True when this process ran nvcc
        self.compiler_log = ""  # nvcc's stderr (ptxas -v output with verbose)

    def build(self, verbose: bool = False) -> str:
        """Compile and link if the sources changed; returns the library
        path.  ``verbose`` adds ``-Xptxas -v`` (registers, spills)."""
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
        digest = source_hash(srcs)
        os.makedirs(self.build_dir, exist_ok=True)
        lib_path = os.path.join(self.build_dir, LIB_NAME)
        stamp = lib_path + ".sha256"
        with open(os.path.join(self.build_dir, "lock"), "w") as lk:
            # one builder per checkout; a concurrent process waits and
            # then finds the library current
            fcntl.flock(lk, fcntl.LOCK_EX)
            if (not verbose and os.path.exists(lib_path)
                    and _read(stamp) == digest):
                return lib_path
            nvcc = nvcc_path()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found ($NVCC, PATH, /usr/local/cuda/bin); "
                    "the CUDA kernels cannot be built")
            extra = ("-Xptxas", "-v") if verbose else ()
            objs = [os.path.join(self.build_dir,
                                 os.path.basename(s)[:-3] + ".o")
                    for s in srcs]
            cmds = [[nvcc, *NVCC_FLAGS, *extra, "-c", s, "-o", o]
                    for s, o in zip(srcs, objs)]
            with ThreadPoolExecutor(max_workers=len(cmds)) as ex:
                runs = list(ex.map(_run, cmds))
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            runs.append(_run([nvcc, *NVCC_FLAGS, "-shared", *objs,
                              "-o", tmp]))
            os.replace(tmp, lib_path)
            with open(stamp, "w") as f:
                f.write(digest)
            self.built = True
            self.compiler_log = "".join(r.stderr for r in runs)
        return lib_path

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(self.build())
            return self._lib

    def function(self, name: str, n_ptrs: int, n_ints: int):
        """A bound entry point taking ``n_ptrs`` device pointers, then
        ``n_ints`` ints, then the stream; returns a CUDA error code."""
        lib = self.get()
        with self._lock:
            fn = self._fns.get(name)
            if fn is None:
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                               + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                self._fns[name] = fn
            return fn


def check_operands(kernel: str, **tensors) -> None:
    """Raise unless every operand is a contiguous int32 tensor on one
    CUDA device — what the C entry points take as raw pointers."""
    import torch
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"the other operands on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, not int32")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except FileNotFoundError:
        return ""


def _run(cmd: List[str]) -> subprocess.CompletedProcess:
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    return r


# the process-wide library: a shared object is loaded once per process
LIBRARY = KernelLibrary()

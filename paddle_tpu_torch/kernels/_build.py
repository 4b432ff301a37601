"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` holds plain C entry points (no PyTorch headers)
and is compiled on its own by ``nvcc`` for sm_90a into a shared library
under ``kernels/build/`` (listed in ``.gitignore``). The library's name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once. ``build()`` starts one ``nvcc`` per
source, all together, and waits for all of them.

The wrappers in the kernel modules set each entry's ``argtypes``
(``c_void_p`` for pointers and the stream, ``c_int`` for ints) and raise
when the entry returns a CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load",
           "build_logs", "find_nvcc"]

CSRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # name -> nvcc output of this process


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, ``$CUDA_HOME`` or the default toolkit
    location; raises when there is none."""
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, "
                       "/usr/local/cuda): the CUDA kernels cannot be "
                       "built")


def _sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> List[str]:
    """Compile (where not built yet) and load the named kernel
    libraries, default every ``csrc/*.cu``: one ``nvcc`` per source,
    started together. Returns the names that were compiled now."""
    with _lock:
        todo = [n for n in (names or _sources()) if n not in _libs]
        jobs = []
        for name in todo:
            out = _lib_path(name)
            if out.is_file():
                jobs.append((name, out, None, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:     # wait for every nvcc
            if proc is None:
                continue
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                              f"{log}")
            else:
                os.replace(tmp, out)          # atomic publish
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name, out, _tmp, _proc in jobs:
            _libs[name] = ctypes.CDLL(str(out))
        return [name for name, _o, _t, proc in jobs if proc is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    this process has not."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name]
    return lib

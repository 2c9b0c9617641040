"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, at first use, into
``_build/lib<name>-<hash>.so``: a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The hash covers the
source and the flags, so an edited source rebuilds. ``build_all`` starts
one nvcc per source, all at once.

Host code (``csrc/<name>.cpp``: the bulk loader's splitter) builds the
same way with g++ (``load_host``), into the same directory. A failed
build raises with the compiler's output. Two processes may build at
once: each compiles into a name of its own and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD = os.path.join(HERE, "_build")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources():
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{name}-{h}.so")


def _start(name: str):
    out = _target(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.perf_counter()


def _log_path(target: str) -> str:
    return target[: -len(".so")] + ".log"


def _finish(name: str, proc, tmp: str, out: str, t0: float) -> float:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    # the compiler's report (-Xptxas -v) is kept beside the library, so a
    # later process that finds the library current can still show it
    with open(_log_path(out), "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all() -> Dict[str, Tuple[Optional[float], str]]:
    """Build every source that has no current library, in parallel.
    Returns name -> (build seconds, or None where the library was already
    current; the compiler's output of that library's build)."""
    os.makedirs(BUILD, exist_ok=True)
    started = {
        n: _start(n) for n in sources() if not os.path.exists(_target(n))
    }
    secs = {n: _finish(n, *job) for n, job in started.items()}
    report = {}
    for n in sources():
        with open(_log_path(_target(n))) as f:
            report[n] = (secs.get(n), f.read())
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _target(name)
        if not os.path.exists(path):
            os.makedirs(BUILD, exist_ok=True)
            _finish(name, *_start(name))
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib


def _host_target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cpp"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{name}-{h}.so")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, built
    with g++ if needed. Raises with the compiler's output when the build
    fails."""
    key = name + ".cpp"
    lib = _loaded.get(key)
    if lib is None:
        path = _host_target(name)
        if not os.path.exists(path):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: csrc/{name}.cpp cannot be built")
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [gxx, *HOST_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cpp")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}")
            os.replace(tmp, path)
        lib = _loaded[key] = ctypes.CDLL(path)
    return lib

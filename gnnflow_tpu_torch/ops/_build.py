"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, then loaded with ``ctypes``.
Builds land in ``build/`` at the repository root, named by a hash of the
source, so an edited kernel is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

No fast-math flag is passed: the GRU kernel's time encoding needs
``cosf`` with full range reduction (``dts`` reaches ~1e6).

The store's ingestion helper, ``csrc/ingest.cc``, is host C++: the
``nvcc`` build and :func:`sources` see only ``*.cu``, and
:func:`build_host` compiles a ``.cc`` source with ``$CXX`` (default
``g++``) into ``build/`` the same way, named by a hash of source and
flags.  A build that fails, or finds no compiler, raises with the
compiler's output; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# no -march=native: the sort needs no vector ISA, and the library stays
# loadable on another host of the same architecture
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_file(source: str, flags: List[str], build_dir: str) -> str:
    """``build_dir/lib<name>-<hash of the source and flags>.so``."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode())
    name = os.path.splitext(source)[0]
    return os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:12]}.so")


def lib_path(name: str) -> str:
    """Path of the built library of ``csrc/<name>.cu``."""
    return _lib_file(name + ".cu", NVCC_FLAGS, BUILD_DIR)


def sources() -> List[str]:
    """Kernel source names (``csrc/<name>.cu``; not the host ``.cc``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(names=None) -> Dict[str, str]:
    """Compile the named kernels (default: all) in parallel; return each
    one's ``nvcc`` output (register and shared-memory use).  Raises if any
    build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = out + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        _loaded[name] = lib
    return lib


def host_lib_path(name: str, build_dir: str = BUILD_DIR) -> str:
    """Path of the built library of the host source ``csrc/<name>.cc``."""
    return _lib_file(name + ".cc", HOST_FLAGS, build_dir)


def build_host(name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``csrc/<name>.cc`` with the host compiler (``$CXX``, else
    ``g++``) unless its library exists; return the library's path.  The
    library is written to a temporary file and renamed into place, so
    processes that build at once never load a partial file.  Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    out = host_lib_path(name, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    tmp = out + f".{os.getpid()}.tmp"
    cmd = [*cxx, *HOST_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cc")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler {cxx[0]!r} not found: csrc/"
                           f"{name}.cc cannot be built ({e})") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cc``, built on
    first use."""
    key = name + ".cc"
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(build_host(name))
        _loaded[key] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point of
    ``lib`` (every kernel library exports ``cuda_error_string``)."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what} failed: CUDA error {err} ("
                           f"{lib.cuda_error_string(err).decode()})")

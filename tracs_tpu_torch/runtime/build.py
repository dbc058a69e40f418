"""Builds the port's native code at first use, into the git-ignored
``build/`` directory of the checkout, and loads it with ctypes.

Three kinds of library are built here:

* the host library ``src/tracs_native.cpp`` (FASTA packing, CSV row
  formatting), with g++ into ``build/native/``;
* the port's own host code beside its kernels,
  ``tracs_tpu_torch/csrc/<name>.cpp`` (the tiled mismatch-position kernel's
  tile plan), with g++ into ``build/native/``;
* the hand-written CUDA kernels ``tracs_tpu_torch/csrc/<name>.cu``, with
  nvcc for Hopper (``sm_90a``) into ``build/kernels/``.  Each exposes a
  plain C entry point that takes device pointers and a stream as
  ``void*`` and returns ``cudaGetLastError()``.

A library's file name carries a digest of its source, the headers it may
include (``csrc/*.cuh``) and its compiler command, so an edited source or
header is rebuilt and never served stale.  Each build writes
to a temporary name and ``os.replace``s it into place, so parallel
processes (pytest-xdist workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from tracs_tpu_torch.runtime.profiling import count, span

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
BUILD_DIR = os.path.join(REPO_ROOT, "build")
CSRC_DIR = os.path.join(REPO_ROOT, "tracs_tpu_torch", "csrc")

#: nvcc flags for every kernel: Hopper only (``wgmma``/``setmaxnreg`` need the
#: ``a`` target); ``-Xptxas -v`` reports registers, shared memory and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the kernel sources ``csrc/<name>.cu``: the eight of the port's paths
#: (``doctor`` and chip_smoke.py build all of them)
KERNELS = ("split_gram", "popcount_gram", "split_gram_mma", "mism_positions", "partial_gram",
           "coo_extract", "split_layout", "trans_k_loop")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A compiler was missing or refused a source."""


def compile_library(src: str, out_dir: str, stem: str, argv: list[str],
                    timeout: float = 600, deps: tuple[str, ...] = ()) -> tuple[str, str]:
    """Compile ``src`` into ``out_dir/lib<stem>-<digest>.so`` unless that file
    exists.  ``argv`` is the compiler command with ``{out}`` where the output
    path goes; ``deps`` are the files the source includes, which the digest
    covers too.  Returns (library path, compiler output; empty when cached).
    Each compiler run is counted in ``kernel.builds`` and spanned as
    ``kernel.build`` (attr ``lib``: the stem)."""
    content = b""
    for path in (src, *deps):
        with open(path, "rb") as fh:
            content += fh.read()
    digest = hashlib.sha256(content + "\0".join(argv).encode()).hexdigest()[:16]
    out = os.path.join(out_dir, f"lib{stem}-{digest}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=f".{stem}-", suffix=".so")
    os.close(fd)
    try:
        cmd = [tmp if a == "{out}" else a for a in argv]
        count("kernel.builds")
        try:
            with span("kernel.build", lib=stem):
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise BuildError(f"{cmd[0]} failed to run: {e}") from e
        if r.returncode != 0:
            raise BuildError(
                f"building {os.path.basename(src)} failed (rc {r.returncode}):\n"
                f"{' '.join(cmd)}\n{r.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, r.stdout + r.stderr


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise BuildError("nvcc not found (looked on PATH and in /usr/local/cuda)")
    return path


def build_cuda_library(name: str) -> tuple[str, str]:
    """Build ``csrc/<name>.cu`` for sm_90a.  Returns (path, compiler output)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    argv = [nvcc_path(), *NVCC_FLAGS, "-o", "{out}", src]
    headers = tuple(sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                           if f.endswith(".cuh")))
    return compile_library(src, os.path.join(BUILD_DIR, "kernels"), name, argv, deps=headers)


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/<name>.cpp`` (plain C++ that a kernel's
    wrapper runs on the host), built with g++ into ``build/native/`` on first
    use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            src = os.path.join(CSRC_DIR, f"{name}.cpp")
            argv = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src, "-o", "{out}"]
            path, _ = compile_library(src, os.path.join(BUILD_DIR, "native"), name, argv)
            lib = ctypes.CDLL(path)
            _LOADED[name] = lib
        return lib


def load_cuda_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path, _ = build_cuda_library(name)
            lib = ctypes.CDLL(path)
            _LOADED[name] = lib
        return lib

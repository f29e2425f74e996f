"""Builds the CUDA sources in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` inside this
package (the directory is git-ignored); the hash covers the source, the
headers and the flags, so an edited source is rebuilt and a stale library is
never loaded. Building happens at first use, never at import: the CPU test
machines have no nvcc. Every source compiles in its own nvcc process, all
started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
SOURCES = ("short_seq_attention", "fused_dit_block", "groupnorm_silu",
           "flash_attention", "blend_eps", "matmul")


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compiles every named source whose library is missing, in parallel.
    Returns {name: library path}. Raises with nvcc's output on failure.
    ``verbose`` adds ``-Xptxas -v`` (registers, spills, shared memory per
    kernel) and prints nvcc's output."""
    BUILD.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"--- nvcc {n}.cu ---\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build((name,))[name]))

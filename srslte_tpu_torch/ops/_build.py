"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` has a plain C interface (no PyTorch headers), so
one ``nvcc -shared`` per source takes seconds.  The libraries go to
``srslte_tpu_torch/_build/`` under a name that carries a hash of the source, so
an edited source is rebuilt and a stale library is never loaded.  Nothing is
built when the package is imported: `load` builds at first use, and
`build_all` starts one compiler per source at the same time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("tdec_siso", "viterbi", "graph_cond")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names=SOURCES, force: bool = False) -> dict:
    """Compile the named sources in parallel; returns {name: compiler log}.

    Raises RuntimeError with the compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and not force:
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of one source, built first if it is missing."""
    path = _lib_path(name)
    if not path.exists():
        build_all((name,))
    return ctypes.CDLL(str(path))

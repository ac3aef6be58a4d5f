"""Build the port's CUDA sources with ``nvcc``, load them with ``ctypes``,
and check what the wrappers hand them.

No counterpart in ``src/repro/``: Pallas kernels are traced in Python, while
the port's kernels are CUDA C++ for Hopper (``sm_90a``) under ``csrc/``,
each exposing a plain C launcher.  A source is compiled at its first use
into ``build/kernels/`` at the root of the checkout, one shared library per
source, named by a hash of the source and flags so that an edited source
is rebuilt.  :func:`build` compiles several sources in parallel (one
``nvcc`` each) and returns what ``-Xptxas -v`` reported.  Nothing is built
when a module is imported: the CPU tests import every module and have no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

__all__ = ["BUILD_DIR", "CSRC", "DTYPE_CODES", "SOURCES", "build",
           "check_cuda_operands", "find_nvcc", "load", "nvcc_command",
           "on_cpu"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: <checkout>/build/kernels (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: every CUDA source of the package, by stem
SOURCES = ("logreg_grad", "kmeans_assign")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries, by source stem (a shared library is process-wide anyway)
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, the toolkit's default prefix,
    then ``PATH``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source with the CUDA "
        "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    """The ``nvcc`` command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [nvcc, *_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once (one
    ``nvcc`` process each), and return each one's compiler output.  A
    source already built returns an empty string."""
    names = list(names)
    logs = {name: "" for name in names}
    todo = [n for n in names if not _library_path(n).is_file()]
    if not todo:
        return logs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in todo:
            out = _library_path(name)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(nvcc_command(nvcc, name, tmp),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            procs.append((name, proc, tmp, out))
        for name, proc, tmp, out in procs:
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                    f"{logs[name]}")
            os.replace(tmp, out)     # atomic: a concurrent loader never
                                     # sees a half-written library
    finally:
        for _, proc, tmp, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(_library_path(name)))
    return _LOADED[name]


#: X dtypes the kernels take, by the code their C launchers switch on
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(X: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); any other device raises — there is no
    fallback between the two."""
    if X.device.type in ("cpu", "cuda"):
        return X.device.type == "cpu"
    raise ValueError(f"no kernel or plain version for device {X.device}")


def check_cuda_operands(X: torch.Tensor, *others: torch.Tensor) -> None:
    """Refuse what the kernels do not take, before any pointer is passed:
    X is (P, n, d), fp32 or bf16, non-empty, with a contiguous last
    dimension, P ≤ 65535 (a grid dimension) and n, d below 2³¹; the other
    operands lie on X's device."""
    if X.dtype not in DTYPE_CODES:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if X.stride(-1) != 1:
        raise ValueError("X's last dimension must be contiguous (stride 1)")
    if X.numel() == 0:
        raise ValueError(f"empty X{tuple(X.shape)}")
    if X.shape[0] > 65535 or max(X.shape[1:]) > 2**31 - 1:
        raise ValueError(f"X{tuple(X.shape)} exceeds the kernels' grid "
                         f"(65535 partitions) or 32-bit rows/cols")
    for t in others:
        if t.device != X.device:
            raise ValueError(f"operands on {t.device} and {X.device}")

"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``src/repro_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/torch_kernels/`` at the root of
the checkout, keyed by a hash of the source, the headers it includes from
``csrc/`` and the flags, so an unchanged kernel is never rebuilt and an
edited header rebuilds every source that includes it.  Nothing is compiled
at import: a kernel module asks for its library the first time a CUDA
tensor reaches it, and :func:`build_all` compiles every source in
parallel, one ``nvcc`` each.
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

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "nvcc_path", "build_all", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# source stem -> extra nvcc flags.  The quantizer must be byte-exact with
# the reference, and the RHT and the W4A4 GEMM's fused prologue bitwise
# equal to it and to their plain versions, so no multiply-add contraction
# there.
SOURCES = {
    "mixfp4_quant": ["-fmad=false"],
    "mixfp4_gemm_w4a16": [],
    "mixfp4_attn_decode": [],
    "mixfp4_gemm_w4a4": ["-fmad=false"],
    "fwht_rows": ["-fmad=false"],
}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _flags(name: str) -> list[str]:
    return _ARCH + _COMMON + SOURCES[name]


def _sources(path: Path, seen: dict[Path, bytes]) -> dict[Path, bytes]:
    """``path`` and every header it includes from ``csrc/``, transitively,
    with their bytes."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for inc in _INCLUDE.findall(text):
            _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str) -> Path:
    key = hashlib.sha256(" ".join(_flags(name)).encode())
    for path, text in sorted(_sources(CSRC / f"{name}.cu", {}).items()):
        key.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source that has no up-to-date library, all at once.
    Returns ``{name: {"seconds": s, "log": compiler stderr, "cached": b}}``;
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        _stdout, err = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": err,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib

"""Build and load the hand-written CUDA kernels and the host C++ sources.

Each source ``floodseg_tpu_torch/csrc/<name>.cu`` or ``<name>.cpp`` has a
plain C interface. A ``.cu`` is compiled with ``nvcc`` for ``sm_90a``, a
``.cpp`` (host code: the image codec) with the host C++ compiler, into a
shared library under the repository's ``build/kernels/`` directory (listed
in ``.gitignore``) on first use, and loaded with ``ctypes``. The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Several sources build
in parallel, one compiler process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> {"seconds": build time (0 when cached), "log": the compiler's output}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH, CUDA_HOME or "
                       "/usr/local/cuda)")


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found (CXX, c++ or g++ on PATH)")


def _source(name: str) -> Path:
    for ext in (".cu", ".cpp"):
        if (CSRC / f"{name}{ext}").exists():
            return CSRC / f"{name}{ext}"
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _flags(src: Path):
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def _library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha1(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, all at once.

    Raises with the compiler's output if any build fails.
    """
    names = list(names)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:
        if n not in todo:
            BUILD_INFO.setdefault(n, {"seconds": 0.0, "log": "cached"})
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        src = _source(n)
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        compiler = _nvcc() if src.suffix == ".cu" else _cxx()
        cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{Path(proc.args[0]).name} failed for csrc/{_source(n).name} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on first
    use (once, also when several threads ask at the same time)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
    return lib

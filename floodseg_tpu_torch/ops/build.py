"""Build and load the hand-written CUDA kernels.

Each source ``floodseg_tpu_torch/csrc/<name>.cu`` has a plain C interface.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
repository's ``build/kernels/`` directory (listed in ``.gitignore``) on
first use, and loaded with ``ctypes``. The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Several sources build in parallel, one
``nvcc`` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0 when cached), "log": nvcc output}
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


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, all at once.

    Raises with nvcc's output if any build fails.
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
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib

"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is a self-contained source with a plain C entry
point.  At first use each is compiled by ``nvcc`` into its own shared
library under ``build/bigdl_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags, and loaded with ``ctypes``.
All missing libraries are built together, one ``nvcc`` process per
source.  No PyTorch header is compiled, which keeps a build to seconds.

Nothing here runs at import: the module imports on a machine without
``nvcc`` (the CPU tests import every module)."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bigdl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / spill report) of the builds this
# process ran, by kernel name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(src.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build_missing() -> Dict[str, float]:
    """Compile every source without an up-to-date library, all at once.
    Returns the seconds each build took.  Caller holds ``_lock``."""
    todo = [s for s in sources() if not _target(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        out = _target(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    secs, errors = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[src.stem] = log
        if proc.returncode != 0:
            errors.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        secs[src.stem] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("nvcc failed for " + "\n".join(errors))
    return secs


def build_all() -> Dict[str, float]:
    """Build every kernel that is not built yet; seconds per build."""
    with _lock:
        return _build_missing()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            _build_missing()
            lib = _libs[name] = ctypes.CDLL(str(_target(src)))
        return lib

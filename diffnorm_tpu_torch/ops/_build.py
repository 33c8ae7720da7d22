"""Build the port's CUDA kernels with nvcc on first use and load them with ctypes.

Each `diffnorm_tpu_torch/csrc/<name>.cu` exposes a plain C interface and is
compiled on its own into `<build dir>/lib<name>-<hash>.so`. The hash covers
the source, the shared headers `csrc/*.cuh`, the flags and the release line
of the toolkit that builds (`nvcc --version`, read once at the first build),
so an edited source or another toolkit gets a library of its own. The build
directory is `csrc/build/host-<host fingerprint>` unless
`utils.compile_cache.enable_compile_cache` chose another, so a tree copied to
a host of another ISA builds anew. `build` starts one nvcc per missing
library, all at once. Nothing is compiled or loaded at import, and nvcc is
never asked anything at import: the CPU tests import every module on a
machine without nvcc.

Every kernel op adds one to `launch_counts[<kernel>]` where it launches its
kernel, so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = CSRC / "build"  # git-ignored
KERNELS = ("rms_norm_film", "wavenet_chain", "int8_ff", "fused_layer", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launch_counts: collections.Counter = collections.Counter()

_lock = threading.Lock()
_functions: Dict[str, ctypes._CFuncPtr] = {}
_build_dir: Optional[Path] = None  # set_build_dir's choice
_toolkit: Optional[str] = None  # nvcc --version's release line, once read


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def set_build_dir(path) -> None:
    """Build into and load from `path` from now on (enable_compile_cache)."""
    global _build_dir
    _build_dir = Path(path)


def build_dir() -> Path:
    """The directory libraries are built into and loaded from."""
    if _build_dir is not None:
        return _build_dir
    from diffnorm_tpu_torch.utils.compile_cache import host_fingerprint

    return DEFAULT_BUILD_DIR / f"host-{host_fingerprint()}"


def toolkit_release() -> str:
    """The release line of `nvcc --version` (e.g. "Cuda compilation tools,
    release 12.8, V12.8.93"), read at the first call only."""
    global _toolkit
    if _toolkit is None:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                             timeout=120, check=True).stdout
        lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
        _toolkit = lines[0] if lines else out.strip()
    return _toolkit


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = src + " ".join(NVCC_FLAGS).encode() + toolkit_release().encode()
    return build_dir() / f"lib{name}-{hashlib.sha1(key).hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc process
    per source, all started together. Returns {name: compiler output} for
    the sources compiled now; raises if any compile fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, so, tmp, proc in procs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel library `lib`, built on first use,
    with its argument types declared and an int (cudaError_t) result."""
    key = f"{lib}:{symbol}"
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            build([lib])
            fn = getattr(ctypes.CDLL(str(library_path(lib))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

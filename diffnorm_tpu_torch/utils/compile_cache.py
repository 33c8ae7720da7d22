"""The port's compile cache: where the CUDA kernel libraries are built and
found again, shared by every CLI entry point.

Counterpart of diffnorm_tpu/utils/compile_cache.py. The port's only compiled
artifacts are the nvcc libraries of `ops/_build.py`, one per kernel source,
built on first use and loaded with ctypes. A process that finds a library
built for the same source, flags and toolkit loads it and compiles nothing.

Precedence, as in JAX: DIFFNORM_COMPILE_CACHE=0 leaves the current setting
as it is; a non-empty value is the directory, over the caller's
`default_dir` (`diffnorm_tpu_torch/csrc/build/`, git-ignored). With
`host_keyed` (the default) the directory is namespaced by
`host_fingerprint()`, and every library's digest also covers the release
line of `nvcc --version` (read at the first build, never at import and never
on a CPU run), so a library built on another ISA or by another toolkit is
rebuilt and never loaded.

JAX's `min_secs` (the XLA compile time below which nothing is persisted) and
`JAX_COMPILATION_CACHE_DIR` have no counterpart: every kernel library is
worth keeping, and there is no XLA cache to point at. JAX's
`install_cpu_aot_warning_filter` has none either: it drops a line that only
XLA:CPU's AOT loader writes, and the port runs no XLA.
"""

from __future__ import annotations

import hashlib
import os
import platform
from typing import Optional


def host_fingerprint() -> str:
    """Short hash (12 hex characters) of the host's ISA and CPU feature
    flags, as JAX's: a cache directory keyed by it is never shared between
    hosts whose CPUs differ."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line.split(":", 1)[1]
                    break
    except OSError:
        pass
    key = platform.machine() + "|" + " ".join(sorted(feats.split()))
    return hashlib.sha256(key.encode()).hexdigest()[:12]


def enable_compile_cache(default_dir: Optional[str] = None,
                         host_keyed: bool = True) -> None:
    """Point `ops._build` at a persistent library directory (module
    docstring). `default_dir` None is `diffnorm_tpu_torch/csrc/build`."""
    from diffnorm_tpu_torch.ops import _build

    knob = os.environ.get("DIFFNORM_COMPILE_CACHE", "")
    if knob == "0":
        return
    cache_dir = knob or default_dir or str(_build.DEFAULT_BUILD_DIR)
    if host_keyed:
        cache_dir = os.path.join(cache_dir, "host-" + host_fingerprint())
    _build.set_build_dir(cache_dir)

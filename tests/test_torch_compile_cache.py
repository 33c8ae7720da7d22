"""The port's compile cache (diffnorm_tpu_torch/utils/compile_cache.py and
ops/_build.py): tests/test_compile_cache.py's cases on the port, the library
path that follows the chosen directory and the building toolkit, and a
`--cpu` CLI run that never calls nvcc."""

import os
import stat
from pathlib import Path

import pytest

from diffnorm_tpu.utils.compile_cache import host_fingerprint as jax_host_fingerprint
from diffnorm_tpu_torch.ops import _build
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache, host_fingerprint
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

RELEASE = "Cuda compilation tools, release 12.8, V12.8.93"


@pytest.fixture
def fresh_build(monkeypatch):
    """`_build`'s directory and toolkit as at import, restored afterwards."""
    monkeypatch.delenv("DIFFNORM_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(_build, "_build_dir", None)
    monkeypatch.setattr(_build, "_toolkit", None)
    return _build


def test_host_fingerprint_stable_and_short():
    a, b = host_fingerprint(), host_fingerprint()
    assert a == b
    assert len(a) == 12 and all(c in "0123456789abcdef" for c in a)
    assert a == jax_host_fingerprint()  # the same key as the JAX package's


def test_enable_compile_cache_host_keyed(tmp_path, monkeypatch, fresh_build):
    # the default directory is csrc/build, namespaced by the host
    assert fresh_build.build_dir() == _build.CSRC / "build" / f"host-{host_fingerprint()}"
    enable_compile_cache()
    assert fresh_build.build_dir() == _build.CSRC / "build" / f"host-{host_fingerprint()}"
    # host-keyed is the default
    enable_compile_cache(default_dir=str(tmp_path))
    assert fresh_build.build_dir() == tmp_path / f"host-{host_fingerprint()}"
    # opt-out: the directory is used as-is
    enable_compile_cache(default_dir=str(tmp_path), host_keyed=False)
    assert fresh_build.build_dir() == tmp_path
    # DIFFNORM_COMPILE_CACHE=0 leaves the current setting untouched
    monkeypatch.setenv("DIFFNORM_COMPILE_CACHE", "0")
    enable_compile_cache(default_dir="/elsewhere")
    assert fresh_build.build_dir() == tmp_path
    # a non-empty value overrides the caller's default
    monkeypatch.setenv("DIFFNORM_COMPILE_CACHE", str(tmp_path / "override"))
    enable_compile_cache(default_dir="/elsewhere")
    assert fresh_build.build_dir() == tmp_path / "override" / f"host-{host_fingerprint()}"


def test_library_path_follows_the_directory_and_the_toolkit(tmp_path, fresh_build):
    fresh_build._toolkit = RELEASE
    enable_compile_cache(default_dir=str(tmp_path))
    path = fresh_build.library_path("rms_norm_film")
    assert path.parent == tmp_path / f"host-{host_fingerprint()}"
    assert path.name.startswith("librms_norm_film-") and path.suffix == ".so"
    enable_compile_cache(default_dir=str(tmp_path / "other"), host_keyed=False)
    assert fresh_build.library_path("rms_norm_film") == tmp_path / "other" / path.name
    # another toolkit builds a library of its own
    fresh_build._toolkit = RELEASE.replace("12.8", "12.9")
    assert fresh_build.library_path("rms_norm_film").name != path.name


def _fake_nvcc(bin_dir: Path, log: Path) -> None:
    """An `nvcc` on PATH that records every call and prints a release line."""
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\necho '{RELEASE}'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)


def test_toolkit_is_read_once_from_nvcc(tmp_path, monkeypatch, fresh_build):
    log = tmp_path / "nvcc.log"
    _fake_nvcc(tmp_path / "bin", log)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    assert fresh_build.toolkit_release() == RELEASE
    assert fresh_build.toolkit_release() == RELEASE
    assert log.read_text().split("\n")[:-1] == ["--version"]


def test_cpu_cli_run_calls_no_nvcc(tmp_path, monkeypatch, fresh_build):
    """cli.train --cpu on a dummy task whose VAE runs the wavenet_chain op
    (its plain version on the CPU) asks nvcc nothing and builds nothing."""
    from diffnorm_tpu_torch.cli import train
    from diffnorm_tpu_torch.ops import wavenet_chain as chain_ops

    calls = []
    launch = chain_ops._launch
    monkeypatch.setattr(chain_ops, "_launch", lambda *a, **k: calls.append(1) or launch(*a, **k))
    log = tmp_path / "nvcc.log"
    _fake_nvcc(tmp_path / "bin", log)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("DIFFNORM_COMPILE_CACHE", str(tmp_path / "cache"))
    before = dict(_build.launch_counts)
    assert train.main([
        "--cpu", "--task", "dummy_vae", "--feature-dim", "24", "--latent-dim", "3",
        "--chan-mults", "[4]", "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
        "--vae-decoder-heads", "2", "--target-code-size", "16", "--batch-size", "2",
        "--tokens-per-sample", "10", "--dataset-size", "2", "--max-update", "1",
        "--log-interval", "1", "--save-dir", str(tmp_path / "ckpt")]) == 0
    assert calls and not log.exists()
    assert fresh_build._toolkit is None
    assert fresh_build.build_dir() == tmp_path / "cache" / f"host-{host_fingerprint()}"
    assert not (tmp_path / "cache").exists()
    assert dict(_build.launch_counts) == before

"""The port's multi-process dryrun (`cli.dryrun_multichip`, 4 gloo ranks on
the CPU: data 2 x model 2), and cli.train's --heartbeat-timeout watchdog
(`utils/watchdog.py`, as JAX's tests/test_trainer_infra.py:76) and --profile
trace."""

import logging
import subprocess
import sys
import time
from pathlib import Path

import pytest

from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.utils import watchdog as watchdog_mod
from diffnorm_tpu_torch.utils.watchdog import Watchdog
from tests import torch_dist_worker as W
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
DRYRUN_TIMEOUT_S = 120


def test_dryrun_passes_every_stage_at_four_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "diffnorm_tpu_torch.cli.dryrun_multichip", "--ranks", "4",
         "--cpu", "--timeout", str(DRYRUN_TIMEOUT_S)], cwd=REPO, capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT_S + 30)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for stage in range(1, 11):
        assert any(f"stage {stage}:" in line for line in lines), stage
    summary = lines[-1]
    assert summary.startswith("dryrun_multichip ok: 4 ranks (dp=2 x tp=2, fsdp on, "
                              "pp=4-stage, sp=4-way ring, inference dp+dpxtp pinned)"), summary
    for key in ("nar", "vae", "diff", "diff-post-restore", "w2v", "hubert"):
        assert f" {key} loss=" in summary, key


def test_watchdog_fires(caplog):
    w = Watchdog(timeout=0.2, kill=False).start()
    time.sleep(0.7)
    w.stop()
    # the error path logged (the stack dump goes to stderr)
    assert any("watchdog" in r.message for r in caplog.records)


def test_watchdog_quiet_while_petted(caplog):
    w = Watchdog(timeout=0.4, kill=False).start()
    for _ in range(8):
        time.sleep(0.05)
        w.pet()
    w.stop()
    assert not any("watchdog" in r.message for r in caplog.records)
    assert Watchdog(0).start()._thread is None  # a timeout of 0 starts nothing


def test_cli_train_heartbeat_timeout_and_profile(tmp_path, monkeypatch):
    """--heartbeat-timeout starts the watchdog with its timeout and every
    update pets it; --profile writes a non-empty Chrome trace to
    SAVE_DIR/profile (or --profile-dir)."""
    made = []

    class Recording(Watchdog):
        def __init__(self, timeout, kill=True):
            super().__init__(timeout, kill)
            self.pets = 0
            made.append(self)

        def pet(self):
            self.pets += 1
            super().pet()

    monkeypatch.setattr(train_cli, "Watchdog", Recording)
    argv = W.TASK_ARGV["vae"] + ["--cpu", "--dataset-size", "2", "--max-update", "2",
                                 "--save-dir", str(tmp_path / "ckpt"), "--log-interval", "1",
                                 "--heartbeat-timeout", "600", "--profile"]
    assert train_cli.main(argv) == 0
    (dog,) = made
    assert dog.timeout == 600 and dog.pets == 2 and dog._stop.is_set()
    trace = tmp_path / "ckpt" / "profile" / "trace_rank0.json"
    assert trace.stat().st_size > 0 and b"traceEvents" in trace.read_bytes()[:4096]
    assert train_cli.main(argv[:-3] + ["--profile", "--max-update", "3", "--profile-dir",
                                       str(tmp_path / "prof")]) == 0
    assert (tmp_path / "prof" / "trace_rank0.json").stat().st_size > 0
    assert made[1].timeout == 0 and made[1]._thread is None  # no --heartbeat-timeout


def test_watchdog_module_is_the_ports_own():
    assert watchdog_mod.__name__.startswith("diffnorm_tpu_torch.")
    logging.getLogger(watchdog_mod.__name__)  # its errors log under the port's name

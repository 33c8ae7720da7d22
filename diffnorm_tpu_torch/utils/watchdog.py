"""Training-stall watchdog (the port's copy of diffnorm_tpu/utils/watchdog.py;
reference fairseq/distributed/distributed_timeout_wrapper.py, which kills
hung ranks).

A heartbeat thread: the train loop pets it every step; if no heartbeat
arrives within `timeout` seconds the watchdog logs a stack dump of every
thread and (optionally) sends SIGINT to the process, mirroring the
reference's hang-breaking behavior around blocking collectives.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


class Watchdog:
    def __init__(self, timeout: float, kill: bool = True):
        self.timeout = timeout
        self.kill = kill
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self.timeout <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def pet(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(min(self.timeout / 4, 30.0)):
            idle = time.monotonic() - self._last
            if idle > self.timeout:
                logger.error(
                    "watchdog: no heartbeat for %.0fs (timeout %.0fs); "
                    "dumping stacks%s", idle, self.timeout,
                    " and sending SIGINT" if self.kill else "",
                )
                faulthandler.dump_traceback(file=sys.stderr)
                if self.kill:
                    os.kill(os.getpid(), signal.SIGINT)
                    return

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

"""Windows service integration (reference: cmd/agent/main_windows.go —
kardianos/service wrapping the agent loop as an NT service).

No pywin32: service registration shells to sc.exe (runner-seam
testable); the service process itself is this package run with
``--run-as-service``, which is a plain foreground loop — Windows'
service control manager tolerates console apps started via a wrapper
(sc.exe start with ``cmd /c`` shim) for the skeleton; a full SCM
handshake (SERVICE_STATUS via ctypes advapi32) is the documented
follow-up and does not change this module's surface.

A copy of the JAX package's ``agent/win/service.py``, its code byte for
byte apart from the service's command line: ``WinService.install``
registers ``-m pbs_plus_tpu_torch agent`` where the reference registers
``-m pbs_plus_tpu agent``."""

from __future__ import annotations

import subprocess
import sys
from typing import Callable

Runner = Callable[..., "subprocess.CompletedProcess"]

SERVICE_NAME = "PBSPlusTPUAgent"


class WinService:
    def __init__(self, *, run: Runner = subprocess.run):
        self._run = run

    def install(self, *, server: str, state_dir: str) -> None:
        bin_path = (f'"{sys.executable}" -m pbs_plus_tpu_torch agent '
                    f'--server {server} --state-dir "{state_dir}"')
        self._run(["sc.exe", "create", SERVICE_NAME,
                   "binPath=", bin_path, "start=", "auto",
                   "DisplayName=", "PBS Plus TPU Agent"],
                  check=True, capture_output=True, timeout=60)
        self._run(["sc.exe", "description", SERVICE_NAME,
                   "PBS Plus TPU backup agent"],
                  capture_output=True, timeout=60)
        # restart on failure: 5s, 30s, then 60s (reference service
        # recovery settings)
        self._run(["sc.exe", "failure", SERVICE_NAME, "reset=", "86400",
                   "actions=", "restart/5000/restart/30000/restart/60000"],
                  capture_output=True, timeout=60)

    def uninstall(self) -> None:
        self._run(["sc.exe", "stop", SERVICE_NAME],
                  capture_output=True, timeout=60)
        self._run(["sc.exe", "delete", SERVICE_NAME],
                  check=True, capture_output=True, timeout=60)

    def start(self) -> None:
        self._run(["sc.exe", "start", SERVICE_NAME],
                  check=True, capture_output=True, timeout=60)

    def stop(self) -> None:
        self._run(["sc.exe", "stop", SERVICE_NAME],
                  check=True, capture_output=True, timeout=60)

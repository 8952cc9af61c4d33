"""The port's log lines against the JAX package's.

The JAX package logs one JSON object a line (``time``, ``level``,
``msg``, the scope fields, ``exc``) and drops a repeat of the same
level, message and scope inside ``LOG_DEDUP_WINDOW`` seconds, on stderr
and in the server's ``--log-file`` alike (``pbs_plus_tpu/utils/log.py``).
The port's modules log through ``logging.getLogger(__name__)`` and scope
through ``logging.LoggerAdapter``; its command line sets the package's
log up with ``__main__._log_to_stderr`` and the file with
``utils/log.add_rotating_file``.

Each package runs the same script in an interpreter of its own (the
loggers and the dedup table are process-wide), with ``time.monotonic``
on a clock the script moves: plain, scoped and exception records,
repeats inside and outside the window, a scope given in another order.
Both give the same lines, ``time`` aside, on stderr and in the file,
and the file holds what stderr shows.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX = r"""
import sys, time
clock = [1000.0]
time.monotonic = lambda: clock[0]
from pbs_plus_tpu.utils.log import L, add_rotating_file
add_rotating_file(sys.argv[1])

def scoped(**kw):
    return L.with_scope(**kw)
"""

_PORT = r"""
import logging, sys, time
clock = [1000.0]
time.monotonic = lambda: clock[0]
from pbs_plus_tpu_torch.__main__ import _log_to_stderr
_log_to_stderr()
from pbs_plus_tpu_torch.utils.log import add_rotating_file
add_rotating_file(sys.argv[1])
L = logging.getLogger("pbs_plus_tpu_torch.server.jobs")

def scoped(**kw):
    return logging.LoggerAdapter(L, kw)
"""

# the common part, compiled from a file of its own so that a traceback
# names the same file and lines in both interpreters
_BODY = r"""
L.info("job %s queued", "j1")
clock[0] += 1.0
L.info("job %s queued", "j1")              # inside the window: dropped
L.warning("job %s queued", "j1")           # another level
scoped(job_id="j1").info("job %s queued", "j1")      # another scope
scoped(job_id="j1", kind="backup").warning("slot %d granted", 3)
scoped(kind="backup", job_id="j1").warning("slot %d granted", 3)  # same scope
scoped(job_id="j2", kind="backup", tries=2).error("agent %s gone", "h1")
L.debug("below the level")
try:
    raise ValueError("boom")
except ValueError:
    L.exception("verify %s failed", "v1")
clock[0] += 1.0
try:
    raise ValueError("boom")
except ValueError:
    L.exception("verify %s failed", "v1")  # dropped
clock[0] += 4.5                              # 6.5 s after the first line
L.info("job %s queued", "j1")
scoped(job_id="j1", kind="backup").warning("slot %d granted", 3)
L.info("job %s queued", "j1")              # dropped again
"""


def _run(prelude: str, tmp_path, name: str, window: str):
    body = tmp_path / "body.py"
    body.write_text(_BODY)
    log_file = tmp_path / name / "server.log"
    script = prelude + (f"exec(compile(open({str(body)!r}).read(), "
                        f"'body.py', 'exec'))\n")
    env = dict(os.environ, LOG_DEDUP_WINDOW=window, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script, str(log_file)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    stderr = [json.loads(x) for x in r.stderr.splitlines()]
    in_file = [json.loads(x) for x in log_file.read_text().splitlines()]
    assert stderr == in_file
    for entry in stderr:
        assert entry.pop("time")
    return stderr


@pytest.mark.parametrize("window,lines", [("5", 8), ("0", 12)])
def test_json_lines_and_dedup_window_match_reference(tmp_path, window,
                                                     lines):
    ref = _run(_JAX, tmp_path, "jax", window)
    port = _run(_PORT, tmp_path, "port", window)
    assert port == ref
    assert len(port) == lines
    assert port[0] == {"level": "INFO", "msg": "job j1 queued"}
    assert {"level": "WARNING", "msg": "slot 3 granted", "job_id": "j1",
            "kind": "backup"} in port
    exc = [e for e in port if "exc" in e]
    assert exc and exc[0]["msg"] == "verify v1 failed"
    assert exc[0]["exc"].endswith("ValueError: boom")

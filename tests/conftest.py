"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-chip sharding validated
without TPU hardware, per the reference's in-process test philosophy —
SURVEY §4: unit tests need no cluster).  Env must be set before jax import.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the env pre-sets a TPU platform
# persistent compile cache: the sha256/rolling-hash scans compile once per
# (t_max, batch) bucket — cache across test runs
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_test_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# this image preloads jax at interpreter startup with a TPU platform plugin
# already registered — env vars alone are too late; force via jax.config
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def fs_witness(request):
    """Runtime fs-protocol witness (utils/fswitness.py,
    docs/protocols.md): records every rename/link/unlink/open plus the
    product tree's ``fswitness.note`` events and fails the test on a
    torn durable write, a non-staged publish, or a declared-ordering
    inversion.  The chaos/crash batteries wire this autouse (crashes
    are exactly when publish ordering interleaves); ``PBS_PLUS_FSWITNESS=0``
    opts out globally, ``@pytest.mark.no_fswitness`` per test (for
    tests that deliberately write torn files to prove the READER
    rejects them)."""
    from pbs_plus_tpu.utils import fswitness
    if os.environ.get(fswitness.ENV_VAR, "1") == "0" or \
            request.node.get_closest_marker("no_fswitness"):
        yield None
        return
    with fswitness.watching() as w:
        yield w
    w.assert_clean()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: fleet-scale soak profiles (N=500; runs in the default "
        "loop, deselect with -m 'not slow' for a quick pass)")
    config.addinivalue_line(
        "markers",
        "no_fswitness: opt a test out of the default-on fs-protocol "
        "witness (utils/fswitness.py) — for tests that deliberately "
        "write torn files to prove the READER rejects them")
    config.addinivalue_line(
        "markers",
        "cuda: runs the port's kernels on a CUDA device; skips without one")

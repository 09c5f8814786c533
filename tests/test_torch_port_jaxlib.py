"""Loading the JAX package's host-plan library from several test workers.

``segdino3d_tpu.ops.host_plan._load`` runs ``make -C native/sparseplan``
whenever ``native/sparseplan/libsparseplan.so`` is missing (it is
git-ignored, so a clean checkout has none) and then ``ctypes.CDLL``s it.
With several test workers, one may find the file while another's linker is
still writing it and fail with ``OSError: ... file too short``; or two
``make``s may write one file at once.  The JAX module keeps its library
only after a good load, so a retry succeeds once the writer is done.

The port's tests that call the JAX plan builder call
``load_jax_sparseplan`` first (the port's own loader builds under a lock
and renames atomically).
"""
import subprocess
import time

import pytest

from segdino3d_tpu.ops import host_plan as JH

RETRY_SECONDS = 60.0


def load_jax_sparseplan(timeout: float = RETRY_SECONDS, pause: float = 0.5):
    """``JH._load()``, retried on ``OSError`` and
    ``subprocess.CalledProcessError`` for up to ``timeout`` seconds while
    another process may still be building the library."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return JH._load()
        except (OSError, subprocess.CalledProcessError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(pause)


def test_loads_the_jax_library():
    lib = load_jax_sparseplan()
    for name in ("voxel_dedup", "neighbor_table", "downsample"):
        assert hasattr(lib, name)


@pytest.mark.parametrize("error", [OSError("file too short"),
                                   subprocess.CalledProcessError(2, "make")])
def test_retries_while_the_library_is_being_written(monkeypatch, error):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise error
        return "lib"

    monkeypatch.setattr(JH, "_load", flaky)
    assert load_jax_sparseplan(timeout=5.0, pause=0.01) == "lib"
    assert len(calls) == 3


def test_gives_up_after_the_timeout(monkeypatch):
    def broken():
        raise OSError("file too short")

    monkeypatch.setattr(JH, "_load", broken)
    with pytest.raises(OSError):
        load_jax_sparseplan(timeout=0.05, pause=0.01)

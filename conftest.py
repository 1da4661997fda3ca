"""Repo-wide test hooks: the ``slow`` set, and a time limit on every test phase.

The JAX package's Pallas interpret-mode parity runs of K4
(``tests/test_pallas_mesh.py``) and K2 (``tests/test_pallas_grad.py``) take
minutes each on a CPU and compare two pieces of reference code, so they are
marked ``slow`` here by node id (``SLOW``) and left out of tier-1
(``-m 'not slow'``).  Run them with
``python -m pytest -m slow tests/test_pallas_mesh.py tests/test_pallas_grad.py``.
The port is held to the same oracles in tier-1 by
``tests/test_torch_mesh_kernel.py`` and ``tests/test_torch_grad.py``.

Every test's setup, call and teardown each get ``TEST_PHASE_LIMIT_S``
seconds, ``SLOW_PHASE_LIMIT_S`` for a ``slow`` test.  A phase that runs over
fails on its own, with its traceback, and the run goes on.  A hang inside C
code, which the alarm cannot interrupt, is caught ``BACKSTOP_S`` later by
``faulthandler``: it writes every thread's stack to the stderr the run
started with (pytest's capture would swallow it) and ends that process
(under xdist, one worker).
"""

import contextlib
import faulthandler
import os
import signal

import pytest

TEST_PHASE_LIMIT_S = 300
# ~3x the longest slow test alone on one worker (414 s on an 8-core CPU).
SLOW_PHASE_LIMIT_S = 1200
BACKSTOP_S = 60

SLOW = frozenset(
    [f"tests/test_pallas_mesh.py::{name}" for name in (
        "test_mesh_in_cornell_parity",
        "test_textured_mesh_under_hdri_parity",
        "test_example_sphere_merl_hdri_parity",
        "test_tiled_block_remap_parity",
        "test_autopad_partial_region_bitwise",
        "test_deferred_table_grads_match_xla",
        "test_out_of_range_uv_parity",
        "test_example_sphere_merl_mis_parity",
        "test_mesh_merl_mis_parity",
    )]
    + [f"tests/test_pallas_grad.py::{name}" for name in (
        "test_grads_match_jax_value_and_grad",
        "test_odd_size_grads_match_jax_value_and_grad",
        "test_camera_grads_match_jax_value_and_grad",
        "test_sgd_with_pallas_grads_descends",
    )])

_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    config.stash[_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def _phase_limit(item, phase):
    slow = item.get_closest_marker("slow") is not None
    limit = SLOW_PHASE_LIMIT_S if slow else TEST_PHASE_LIMIT_S

    def _expire(signum, frame):
        pytest.fail(f"{item.nodeid}: {phase} ran past the per-test limit "
                    f"of {limit} s (conftest.py)")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + BACKSTOP_S, exit=True,
                                      file=item.config.stash[_STDERR_FD])
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _phase_limit(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _phase_limit(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _phase_limit(item, "teardown"):
        yield

"""The repo-wide test hooks of the root ``conftest.py``.

The time limit runs on a scratch file: a child pytest loads ``conftest`` as
a plugin with the limits patched down to seconds.  A sleep in each of setup,
call and teardown must fail that test alone, with the limit's message; a
``slow`` test gets its own, longer limit; the test after them must pass; and
the child must end in seconds, not after the sleeps.  A test that blocks the
alarm, as a hang in C code does, must end the child through the
``faulthandler`` backstop, whose stack dump must reach the child's stderr
past pytest's capture.

The ``slow`` set must name tests that exist: ``-m slow`` on its two files
collects exactly ``conftest.SLOW``.
"""

import subprocess
import sys
import time
from pathlib import Path

import conftest

REPO = Path(__file__).resolve().parents[1]

SCRATCH = '''
import time
import pytest


@pytest.fixture
def slow_setup():
    time.sleep(30)


@pytest.fixture
def slow_teardown():
    yield
    time.sleep(30)


def test_setup_over(slow_setup):
    pass


def test_call_over():
    time.sleep(30)


def test_teardown_over(slow_teardown):
    pass


@pytest.mark.slow
def test_slow_under_its_limit():
    time.sleep(2)


@pytest.mark.slow
def test_slow_over_its_limit():
    time.sleep(30)


def test_after():
    assert True
'''

HANG = '''
import signal
import time


def test_hang():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)
'''

CHILD = '''
import sys
import pytest
import conftest
conftest.TEST_PHASE_LIMIT_S = 1
conftest.SLOW_PHASE_LIMIT_S = 4
conftest.BACKSTOP_S = 1
sys.exit(pytest.main([sys.argv[1], "-q", "-rA", "-o", "markers=slow",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      "-p", "no:xdist"],
                     plugins=[conftest]))
'''


def _child(tmp_path, source):
    path = tmp_path / "test_scratch.py"
    path.write_text(source)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    return proc, time.monotonic() - t0


def test_phase_over_limit_fails_alone(tmp_path):
    proc, wall = _child(tmp_path, SCRATCH)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    summary = {line.split(" ")[1].split("::")[-1]: line for line in
               out.splitlines() if line.startswith(("PASSED ", "FAILED ",
                                                    "ERROR "))}
    assert summary["test_setup_over"].startswith("ERROR "), out
    assert summary["test_call_over"].startswith("FAILED "), out
    assert summary["test_slow_under_its_limit"].startswith("PASSED "), out
    assert summary["test_slow_over_its_limit"].startswith("FAILED "), out
    assert summary["test_after"].startswith("PASSED "), out
    for phase in ("setup", "call", "teardown"):
        assert f"{phase} ran past the per-test limit of 1 s" in out, out
    assert "call ran past the per-test limit of 4 s" in out, out
    # The call's traceback points at its own sleep.
    line = SCRATCH.splitlines().index("def test_call_over():") + 2
    assert f"test_scratch.py:{line}: " in out, out
    assert "2 failed, 3 passed, 2 errors" in out, out
    assert wall < 30, (wall, out)


def test_hang_past_the_alarm_ends_the_process(tmp_path):
    proc, wall = _child(tmp_path, HANG)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "Timeout (0:00:02)!" in proc.stderr, proc.stderr
    line = HANG.splitlines().index("def test_hang():") + 3
    assert f'test_scratch.py", line {line} in test_hang' in proc.stderr, \
        proc.stderr
    assert wall < 25, (wall, proc.stdout + proc.stderr)


def test_slow_set_names_existing_tests():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m", "slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
         "tests/test_pallas_mesh.py", "tests/test_pallas_grad.py"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ids = {line for line in proc.stdout.splitlines() if "::" in line}
    assert ids == conftest.SLOW, proc.stdout
    assert len(ids) == 13
    assert "13/15 tests collected (2 deselected)" in proc.stdout, proc.stdout

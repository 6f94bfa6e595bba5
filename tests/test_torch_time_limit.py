"""The per-test time limit of the port's tests (``time_limit.py``, armed by
the root ``conftest.py``): a body past its limit fails by the limit with
every thread's stack on stderr, and every test of the port runs with the
limit armed on the main thread, where SIGALRM is delivered."""

import signal
import threading
import time

import pytest

from time_limit import TIME_LIMIT_S, time_limit


def _sleeps_past_its_limit():
    time.sleep(30)


def test_limit_armed_on_the_main_thread():
    assert threading.current_thread() is threading.main_thread()
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= TIME_LIMIT_S


def test_body_fails_by_its_limit_with_its_stack(capfd):
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="time limit of 1 s"):
        with time_limit(1):
            _sleeps_past_its_limit()
    took = time.monotonic() - t0
    assert 1 <= took < 10, took
    err = capfd.readouterr().err
    assert "most recent call first" in err
    assert "_sleeps_past_its_limit" in err
    # the inner limit disarmed the test's own on leaving
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0

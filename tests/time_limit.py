"""A time limit for each phase of the port's tests (``tests/test_torch_*.py``),
armed by the hooks of the repository's root ``conftest.py``."""

import contextlib
import faulthandler
import signal
import sys

import pytest

# Each phase of a test (setup, call, teardown) fails once it has run this
# many seconds: about 4x the slowest phase of the port's tests in the
# tier-1 run with a cold JAX cache beside 8 busy loops on 8 cores (72 s,
# test_torch_cli.py::test_unet_subcommand_matches_jax), so a slow machine
# fails no test, and a stuck test costs its worker this long instead of
# cutting the run.
TIME_LIMIT_S = 300
# A phase stuck in C code never takes the signal; this much later the
# process prints every thread's stack and exits (xdist reports the worker
# down and that test failed, and starts a new worker).
BACKSTOP_S = 60


@contextlib.contextmanager
def time_limit(seconds, backstop_fd=None):
    """Fail the body with every thread's stack if it runs past ``seconds``.

    SIGALRM (main thread only, as xdist runs tests) prints the stacks and
    raises in the body. With ``backstop_fd``, a body stuck in C code is
    ended ``BACKSTOP_S`` later, its stacks written there. Limits do not
    nest: leaving an inner one disarms the outer one."""
    def expire(signum, frame):
        faulthandler.dump_traceback(file=sys.__stderr__)
        pytest.fail(f"took longer than its time limit of {seconds} s "
                    "(stacks of all threads on stderr)")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    if backstop_fd is not None:
        faulthandler.dump_traceback_later(seconds + BACKSTOP_S, exit=True,
                                          file=backstop_fd)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        if backstop_fd is not None:
            faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, old)

"""The port's tests (``tests/test_torch_*.py``) run each phase under
``tests/time_limit.py``'s limit, so a stuck test fails by itself instead of
cutting the run. The JAX package's tests run as ``tests/conftest.py`` sets
them up, with no limit."""

import os
import sys

import pytest

# tests/ goes on the path as pytest puts it there for tests/conftest.py
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
from time_limit import TIME_LIMIT_S, time_limit  # noqa: E402

# the process's own stderr (not a test's captured one) for the backstop
_BACKSTOP_FD = pytest.StashKey()


def pytest_configure(config):
    # pytest's own faulthandler_timeout uses the one faulthandler timer that
    # the backstop would re-arm and cancel; with it set, it alone stands
    config.stash[_BACKSTOP_FD] = (
        None if float(config.getini("faulthandler_timeout") or 0)
        else os.dup(sys.__stderr__.fileno()))


def pytest_unconfigure(config):
    fd = config.stash.get(_BACKSTOP_FD, None)
    if fd is not None:
        os.close(fd)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not item.path.name.startswith("test_torch_"):
        return (yield)
    with time_limit(TIME_LIMIT_S, item.config.stash[_BACKSTOP_FD]):
        return (yield)


# the same limit for each phase: an exception raised inside a phase's hook
# is that phase's failure, so a limit never expires in pytest's bookkeeping
pytest_runtest_setup = pytest_runtest_teardown = pytest_runtest_call

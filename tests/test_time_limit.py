"""The per-test time limit of ``tests/conftest.py``: an inner pytest session
that loads that conftest runs a test that sleeps past its limit, one that
spins in a Python loop past it, and a quick one after them. The first two
fail with the limit's message, the third passes, and the session (pytest's
own clock, which leaves out the interpreter's start and the conftest's
imports) ends soon after the limits expire."""

import re
from pathlib import Path

pytest_plugins = ["pytester"]

INNER = """
import time

import pytest


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    time.sleep(5)


@pytest.mark.time_limit(1)
def test_spins_past_its_limit():
    while True:
        pass


def test_quick():
    assert True
"""


def test_a_test_past_its_limit_fails_and_the_run_goes_on(pytester):
    pytester.makeconftest((Path(__file__).parent / "conftest.py").read_text())
    pytester.makepyfile(test_inner=INNER)
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider", "-p", "no:randomly", timeout=120)
    result.assert_outcomes(passed=1, failed=2)
    for name in ("test_sleeps_past_its_limit", "test_spins_past_its_limit"):
        result.stdout.fnmatch_lines([f"*TimeLimitExceeded: test_inner.py::{name}: call ran past its time limit of 1 s*"])
    wall = float(re.search(r" in ([0-9.]+)s", result.stdout.lines[-1]).group(1))
    assert wall < 10.0, result.stdout.lines[-1]

"""Fixtures of the benchmark's CPU tests."""

import copy

import pytest

from benchmark.tests.helpers import tiny_bench


@pytest.fixture
def bench():
    return copy.deepcopy(tiny_bench())

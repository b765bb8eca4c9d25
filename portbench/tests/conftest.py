"""Tests of the port's benchmark. Run here on the CPU with

    python3 -m pytest portbench/tests -q

and the ones marked ``card`` on the H100 with

    python3 -m pytest portbench/tests -m card -q

A ``card`` test decides inside itself whether a CUDA card is visible,
and skips when none is."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _short_idle_settle(monkeypatch):
    """The CPU runs' dispatcher idles after its 0.5 s empty pop too; the
    card's runs keep the harness's longer settle."""
    from portbench import harness

    monkeypatch.setattr(harness, "IDLE_SETTLE_S", 0.6)

"""Limits of the test suite.

pytest loads this file before tests/conftest.py, and so before jax or torch
is imported. The supported run of the whole suite is the Tier-1 command of
ROADMAP.md; its xdist workers are processes of their own.

Each xdist worker, and every process its tests start, gets an equal share
of the cores for its OpenMP and MKL pools: left at one thread per core,
six workers ran some 48 spinning threads on 8 cores, and a test file ran
ten times slower than alone. Every test has a time limit of 300 s over its
setup, call and teardown, so a hung test fails on its own instead of
holding its worker until the suite's limit; a ``subprocess.run`` it is
waiting in kills its child on the way out. The benchmark's tests under
benchmark/ get no such limit.

Tests of the JAX reference package whose call takes a minute or more in a
Tier-1 run, with faster tests covering their parts, are marked ``slow``
below (``pytest tests/ -m slow`` runs them), and the LM chain, which needs
the upstream checkout, skips where that checkout is absent.
"""

import contextlib
import os
import signal
import time

import pytest

pytest_plugins = ["pytester"]

DEFAULT_TIMEOUT_S = 300


def share_cores(environ):
    """Cap OpenMP and MKL at this xdist worker's share of the cores, unless
    the caller set them. Must run before torch is imported."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        share = str(max(1, (os.cpu_count() or 1) // int(workers)))
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            environ.setdefault(var, share)


share_cores(os.environ)

_RELEASE_ROW = "tests/test_fetch_verify.py::test_fetch_and_verify_release_row[{}]"
SLOW = {
    *(_RELEASE_ROW.format(row) for row in (
        "as20k-base", "as20k-small", "audioset-small", "epic-base", "epic-base-as",
        "epic-small", "vggsound-base", "vggsound-base-as", "vggsound-small",
        "voxceleb-base", "voxceleb-base-as", "voxceleb-small")),
    "tests/test_runner.py::test_run_train_and_eval",
    "tests/test_runner.py::test_run_eval_wa_and_ensemble",
    "tests/test_runner.py::test_run_train_resume",
    "tests/test_runner.py::test_run_train_pipeline_parallel",
    "tests/test_selective_scan.py::test_lchunk_exact_pin",
}
NEEDS_REFERENCE = {"tests/test_fetch_verify.py::test_fetch_and_verify_lm_chain"}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    """Mark SLOW before ``-m 'not slow'`` deselects, and skip NEEDS_REFERENCE
    without the upstream checkout."""
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
        if item.nodeid in NEEDS_REFERENCE:
            from aum_tpu.convert.ref_runner import reference_available

            item.add_marker(pytest.mark.skipif(
                not reference_available(), reason="no upstream checkout"))


_LIMIT = pytest.StashKey()
# The benchmark's own tests keep no limit of this file: its card tests run
# cells at full size.
_BENCHMARK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "")


@contextlib.contextmanager
def _limited(item, phase):
    """Run one phase under what is left of the item's limit. The timer runs
    only inside a phase, where pytest turns the failure into a report."""
    if _LIMIT not in item.stash:
        yield
        return
    limit, deadline = item.stash[_LIMIT]

    def expire(signum, frame):
        pytest.fail(f"ran past its {limit} s limit in {phase}")

    start = time.monotonic()
    old_handler = signal.signal(signal.SIGALRM, expire)
    outer, _ = signal.setitimer(signal.ITIMER_REAL, max(deadline - start, 1e-3))
    try:
        yield
    finally:
        left = outer - (time.monotonic() - start)
        signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3) if outer else 0)
        signal.signal(signal.SIGALRM, old_handler)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if not str(item.path).startswith(_BENCHMARK):
        item.stash[_LIMIT] = DEFAULT_TIMEOUT_S, time.monotonic() + DEFAULT_TIMEOUT_S
    with _limited(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _limited(item, "teardown"):
        return (yield)

"""The suite's own limits, set in the repo's root conftest.py: each test's
time limit, each xdist worker's share of the cores, and the tests it marks
by node id."""

import os
import re
import signal
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = {
    "setup": """
        import time
        import pytest

        @pytest.fixture
        def stall():
            time.sleep(30)

        def test_stalls(stall):
            pass
    """,
    "call": """
        import time

        def test_stalls():
            time.sleep(30)
    """,
    "teardown": """
        import time
        import pytest

        @pytest.fixture
        def stall():
            yield
            time.sleep(30)

        def test_stalls(stall):
            pass
    """,
}

OUTCOMES = {"setup": dict(errors=1), "call": dict(failed=1),
            "teardown": dict(passed=1, errors=1)}


@pytest.fixture
def limits(pytestconfig):
    """The root conftest.py, as this session loaded it."""
    path = os.path.join(REPO, "conftest.py")
    (module,) = [p for p in pytestconfig.pluginmanager.get_plugins()
                 if getattr(p, "__file__", None) == path]
    return module


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_limit_fails_a_stalled_test(pytester, monkeypatch, limits, phase):
    monkeypatch.setattr(limits, "DEFAULT_TIMEOUT_S", 1)
    pytester.makepyfile(PHASES[phase])
    start = time.monotonic()
    result = pytester.runpytest_inprocess("-p", "no:cacheprovider", plugins=[limits])
    assert time.monotonic() - start < 10
    result.stdout.fnmatch_lines([f"*ran past its 1 s limit in {phase}*"])
    result.assert_outcomes(**OUTCOMES[phase])


def test_outer_limit_survives_a_nested_session(pytester, monkeypatch, limits):
    before = signal.getitimer(signal.ITIMER_REAL)[0]
    monkeypatch.setattr(limits, "DEFAULT_TIMEOUT_S", 1)
    pytester.makepyfile("import time\n\ndef test_naps():\n    time.sleep(0.5)\n")
    start = time.monotonic()
    pytester.runpytest_inprocess("-p", "no:cacheprovider", plugins=[limits]).assert_outcomes(
        passed=1)
    after = signal.getitimer(signal.ITIMER_REAL)[0]
    assert 0 < after <= before - (time.monotonic() - start) + 0.1


def test_every_test_gets_the_default_limit(limits):
    remaining = signal.getitimer(signal.ITIMER_REAL)[0]
    assert limits.DEFAULT_TIMEOUT_S - 60 < remaining <= limits.DEFAULT_TIMEOUT_S == 300


@pytest.mark.parametrize("workers", [1, 3, 6, 64])
def test_share_cores_under_xdist(limits, workers):
    env = {"PYTEST_XDIST_WORKER_COUNT": str(workers), "MKL_NUM_THREADS": "5"}
    limits.share_cores(env)
    assert env["OMP_NUM_THREADS"] == str(max(1, os.cpu_count() // workers))
    assert env["MKL_NUM_THREADS"] == "5"


def test_share_cores_leaves_a_single_process_alone(limits):
    env = {"OMP_NUM_THREADS": "7"}
    limits.share_cores(env)
    assert env == {"OMP_NUM_THREADS": "7"}


def test_torch_runs_on_the_share():
    torch = pytest.importorskip("torch")
    if "PYTEST_XDIST_WORKER_COUNT" not in os.environ:
        pytest.skip("the share is set in xdist workers only")
    assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])


def test_marked_node_ids_name_tests(limits):
    """A renamed test or release row would drop its mark without a word."""
    rows = open(os.path.join(REPO, "scripts", "fetch_and_verify.sh")).read()
    for nodeid in limits.SLOW | limits.NEEDS_REFERENCE:
        path, name = nodeid.split("::")
        func, _, param = name.partition("[")
        assert f"\ndef {func}(" in open(os.path.join(REPO, path)).read(), nodeid
        if param:
            assert re.search(rf"^REL\[{re.escape(param[:-1])}\]=", rows, re.M), nodeid

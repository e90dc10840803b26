"""The harness end to end on the CPU at tiny sizes: each driver's loop and
result line, the refusal without a card, discovery of new files, the faults
that ``correct`` has to catch, the control, and what the harness imports."""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, trace

BENCH = Path(__file__).resolve().parents[1]
TINY = BENCH / "tests" / "tiny"
CPU = torch.device("cpu")
CELLS = ["tiny-fobi.eval", "tiny-fobi.train", "tiny-fofo-wav.serve"]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def _run(name, trace_on=False, seed=2 ** 31 + 101, seconds=0.5):
    cell = harness.load_cell(name, TINY)
    return harness.run(cell, seed, seconds, trace_on, CPU, time.time())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace_on", [False, True])
def test_rehearsal_result_line(name, trace_on, capsys):
    result = _run(name, trace_on)
    harness.emit(result)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == KEYS | ({"breakdown"} if trace_on else set())
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert out.err.strip().splitlines()[-1].startswith("check ")
    if trace_on:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                           "aum-base-fobi.eval-b64", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_command_refuses_without_the_port(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "aum-base-fobi.eval-b64", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_discovery_of_a_new_cell_and_metric(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "workloads" / "aum-base-fobi.eval-b8.json").write_text(json.dumps({
        "config": "aum-base-fobi", "traffic": "eval-b8", "chips": 1, "why": "a new cell",
        "limits": {"logit_rel_err": 0.1}}))
    traffic = json.loads((root / "traffic" / "eval-b64.json").read_text())
    (root / "traffic" / "eval-b8.json").write_text(json.dumps({**traffic, "batch": 8}))
    (root / "metrics" / "launches.eval-b8.py").write_text(
        'NAME = "launches.eval-b8"\nUNIT = "1"\nWORKLOADS = ["aum-base-fobi.eval-b8"]\n'
        "def read(view):\n    return float(len(view.kernels))\n")
    (root / "metrics" / "kernels" / "scan_fwd_dual" / "renamed.txt").write_text("new_kernel\n")
    cell = harness.load_cell("aum-base-fobi.eval-b8", root)
    assert cell["traffic_spec"]["batch"] == 8 and cell["config_spec"]["model"]["depth"] == 24
    names = [m.NAME for m in harness.metrics_of("aum-base-fobi.eval-b8", root)]
    assert names == ["launches.eval-b8"]
    assert "new_kernel" in [p.pattern for p in trace.kernel_patterns(
        "scan_fwd_dual", root / "metrics" / "kernels")]
    assert harness.driver(cell["traffic_spec"]["driver"], root).end_to_end


def _altered_eval(monkeypatch):
    import aum_tpu_torch.train as train

    real = train.make_eval_step

    def make(model):
        fn = real(model)

        def broken(x):
            out = fn(x).clone()
            out[:, 0] += 1.0  # each answer altered where it is produced
            return out
        return broken
    monkeypatch.setattr(train, "make_eval_step", make)


def _altered_serve(monkeypatch):
    import aum_tpu_torch.serving as serving

    real = serving.load_bundle

    def load(*a, **k):
        served = real(*a, **k)
        predict = served.predict

        def broken(x):
            out = predict(x).clone()
            out[:, 0] += 1.0
            return out
        served.predict = broken
        return served
    monkeypatch.setattr(serving, "load_bundle", load)


def _train_fault(kind):
    def plant(monkeypatch):
        import aum_tpu_torch.train as train

        real = train.make_train_step

        def make(*a, **k):
            step = real(*a, **k)

            def broken(state, batch):
                if kind == "unchanged":  # the state comes back as it went in
                    state.optimizer.step = lambda *_, **__: None
                else:  # half of the batch left out, the mean over the rest
                    b = batch["x"].shape[0] // 2
                    batch = {"x": batch["x"][:b], "y": batch["y"][:b]}
                return step(state, batch)
            return broken
        monkeypatch.setattr(train, "make_train_step", make)
    return plant


@pytest.mark.parametrize("name, plant", [
    ("tiny-fobi.eval", _altered_eval),
    ("tiny-fofo-wav.serve", _altered_serve),
    ("tiny-fobi.train", _train_fault("unchanged")),
    ("tiny-fobi.train", _train_fault("half")),
], ids=["eval-answer", "serve-answer", "train-unchanged", "train-half-batch"])
def test_faults_make_correct_false(name, plant, monkeypatch):
    plant(monkeypatch)
    result = _run(name)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    cell = harness.load_cell(name, TINY)
    drv = harness.driver(cell["traffic_spec"]["driver"])
    session = drv.setup(cell, 31, CPU)
    for _ in range(3):
        session.call()
    out, _ = session.finish()
    program = drv.check(cell, 31, out, CPU)
    assert all(program[k] <= v for k, v in cell["limits"].items())
    for numbers in drv.control(cell, 31, out, CPU).values():
        assert any(numbers[k] > v for k, v in cell["limits"].items())


@pytest.mark.card
@pytest.mark.parametrize("name", ["aum-base-fobi.eval-b64", "aum-base-fobi.train-b48",
                                  "aum-base-fofo-wav.serve-b64"])
def test_control_fails_at_the_cells_size(name, card):
    cell = harness.load_cell(name)
    drv = harness.driver(cell["traffic_spec"]["driver"])
    session = drv.setup(cell, 2 ** 31 + 77, card)
    for _ in range(4):
        session.call()
    out, _ = session.finish()
    program = drv.check(cell, 2 ** 31 + 77, out, card)
    assert all(program[k] <= v for k, v in cell["limits"].items())
    for numbers in drv.control(cell, 2 ** 31 + 77, out, card).values():
        assert any(numbers[k] > v for k, v in cell["limits"].items())


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_the_benchmark():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "math", "numpy", "torch", "benchmark"}, path

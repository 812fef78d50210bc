"""The result line's keys, in order, with the compared numbers last on both
standard error and the line; and a run refused without the cards it needs."""

import json
import os
import subprocess
import sys
import time

from portbench.harness import result
from portbench.harness.trace import Profile

from .conftest import ROOT


def test_last_line_keys(tiny_cell, capsys, monkeypatch):
    cell = tiny_cell("b5_pretrain_b8")
    outcome = cell.loop().run(cell, 31, 0.2, True, time.perf_counter(), device="cpu")
    monkeypatch.setattr(result, "device_info", lambda count, peak: {})
    outcome.device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                      "memory_peak_bytes": 1}
    for trace in (False, True):
        if trace:  # a device profile stands in for the card's
            outcome.run.profile = Profile(device=[("k", 0.0, 1.0), ("k", 2.0, 3.0)],
                                          host=[("portbench.step", 0.0, 3.0)], calls=1)
        result.emit(cell, outcome, trace)
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[:5] == keys and list(line)[-1] == "checks"
        assert set(line["checks"]) == set(cell.limits)
        assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
        assert err.strip().splitlines()[-len(cell.limits):] == [
            f"check {n} {c['value']!r} limit {c['limit']!r}" for n, c in outcome.checks.items()]
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
            assert line["device"]["busy_s"] == 2.0 and line["device"]["window_s"] == 3.0
            assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
            assert "dispatch_ms.train" in line["metrics"]
            assert line["metrics"]["device_idle_share.train"]["value"] == 100.0 / 3.0
        else:
            assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
            assert all(m["value"] > 0 for n, m in line["metrics"].items()
                       if n != "peak_mem_gib")


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "b5_pretrain_b8",
                          "--seed", str(2 ** 33 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "needs 1 CUDA card" in res.stderr


def test_bare_checkout_has_no_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    exits non-zero without a result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "b5_pretrain_b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout.strip() == ""

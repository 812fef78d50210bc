"""BENCHMARK.json against the benchmark's rules, and every piece of every
cell found by name; a new cell made of new files only is found as well."""

import json
import re
import shutil

import pytest

from portbench.harness import manifest

from .conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)


def test_command_and_paths(bench):
    assert 1 <= len(bench["command"]) <= 32 and all(text_ok(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


def test_names_are_unique_and_well_formed(bench):
    groups = [bench["configs"], bench["workloads"], bench["end_to_end"] + bench["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and text_ok(c["source"]) and text_ok(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_workloads(bench):
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:  # each cell that reports it reports what it moves
            assert cell in cells and manifest.reports(moved, cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one
        reported = [m["name"] for m in bench["end_to_end"] if manifest.reports(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(manifest.reports(m, cell) for m in bench["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_every_piece_found_by_name(workload):
    cell = manifest.resolve(workload)
    assert callable(cell.loop().run) and callable(cell.loop().readings)
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_a_new_cell_of_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell, a configuration, a mix and a
    metric by new files and new manifest entries alone."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "extra.json").write_text(
        (BENCH / "configs" / "mammo_clip_b5.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "pretrain_b8.json").read_text())
    traffic["images"]["rows"] = 4
    (root / "portbench" / "traffic" / "pretrain_b4.json").write_text(json.dumps(traffic))
    (root / "portbench" / "limits" / "extra_b4.json").write_text('{"loss_gap": 0.1}')
    (root / "portbench" / "metrics" / "steps.extra.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    bench["configs"].append({"name": "extra", "source": "https://example.org/extra",
                             "file": "portbench/configs/extra.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": "extra_b4", "config": "extra", "traffic": "pretrain_b4",
                               "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "steps.extra", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "train_images_per_s", "workloads": ["extra_b4"]})
    next(m for m in bench["end_to_end"] if m["name"] == "train_images_per_s")[
        "workloads"].append("extra_b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.resolve("extra_b4", root=root, bench_dir=root / "portbench")
    assert cell.traffic["images"]["rows"] == 4 and cell.limits == {"loss_gap": 0.1}
    assert [m["name"] for m in cell.per_layer] == ["steps.extra"]
    assert cell.loop().__file__.startswith(str(root))

    class Run:
        steps = 7

    assert cell.metric_reader("steps.extra")(Run()) == 7.0

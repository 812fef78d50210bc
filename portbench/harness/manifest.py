"""``BENCHMARK.json`` and the files a cell is made of, found by name.

A workload names a configuration and a traffic mix. The configuration's file
is the one its entry names; the mix is ``portbench/traffic/<traffic>.json``,
which names its loop, ``portbench/loops/<loop>.py``; each per-layer
metric is read by ``portbench/metrics/<metric>.py``; the correctness limits
of a cell are ``portbench/limits/<workload>.json``. Adding a cell means
adding such files and entries; nothing here knows any one of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = Path(__file__).resolve().parents[1]


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict  # the configuration's file
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]  # the end-to-end metrics this cell reports
    per_layer: List[Dict]  # the per-layer metrics this cell reports
    limits: Dict  # name -> limit of each number the correctness check compares
    bench_dir: Path

    def loop(self):
        """The module of ``loops/<loop>.py``."""
        return load_module(self.bench_dir / "loops" / f"{self.traffic['loop']}.py",
                           f"portbench_loop_{self.traffic['loop']}")

    def metric_reader(self, name: str):
        """The ``read(run)`` function of ``metrics/<name>.py``."""
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "portbench_metric_" + re.sub(r"\W", "_", name)).read


def load_module(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    config = read_json(root / entry["file"])
    traffic = read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if reports(m, workload)]
    per_layer = [m for m in manifest["per_layer"] if reports(m, workload)]
    limits = read_json(bench_dir / "limits" / f"{workload}.json")
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic, e2e,
                per_layer, limits, bench_dir)

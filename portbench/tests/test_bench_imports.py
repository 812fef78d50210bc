"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the measured program; top-level names compared whole (the
port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "mammo_clip_tpu"]

PROBE = r"""
import json, sys
from pathlib import Path
import portbench.run
from portbench.harness import manifest
for w in manifest.load_manifest()["workloads"]:
    cell = manifest.resolve(w["name"])
    cell.loop()
    for m in cell.per_layer:
        cell.metric_reader(m["name"])
import portbench.readings
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    # the program's modules that the loops call, loaded as a run loads them
    extra = ("import mammo_clip_tpu_torch.train.recipes, mammo_clip_tpu_torch.data.pipeline, "
             "mammo_clip_tpu_torch.eval.embeddings, mammo_clip_tpu_torch.ops.flash_attention")
    loaded = top_level_modules(PROBE.format(extra=extra))
    assert "mammo_clip_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys, portbench.reference.clip, portbench.reference.flops, "
            "portbench.reference.precision\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = top_level_modules(code)
    assert not loaded & set(FORBIDDEN + ["mammo_clip_tpu_torch"])


def test_run_guard_names_whole_top_level_modules(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "mammo_clip_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert run.forbidden_loaded() == ["jaxlib"]

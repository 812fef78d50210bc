"""Import hygiene of the port: it needs nothing beyond the standard library,
torch, numpy, scipy and einops (the card machine has no JAX, Flax, optax, Orbax,
yaml, transformers, PIL, pandas or OpenCV), and no file of it imports JAX or
the JAX package. The pretraining CLI runs (and resumes) with all of those
blocked, as it must on the card."""

import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "mammo_clip_tpu_torch")
BLOCKED = ["jax", "jaxlib", "flax", "optax", "orbax", "yaml", "transformers", "PIL", "pandas",
           "cv2", "mammo_clip_tpu"]


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PACKAGE):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def _sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PACKAGE):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(paths)


def test_port_imports_without_jax_and_host_extras():
    mods = _port_modules()
    for name in ("ops.mbconv6", "cli.pretrain", "train.trainer", "train.checkpoint",
                 "data.datamodule", "data.pipeline", "data.metadata", "utils.logging",
                 "ops.flash_attention", "ops.probes", "benchmarks.probe_flash_attention",
                 "benchmarks.probe_mosaic", "benchmarks.layout_timing", "benchmarks.e6_timing"):
        assert f"mammo_clip_tpu_torch.{name}" in mods
    assert len(mods) > 30
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of these raises ImportError
        sys.path.insert(0, {ROOT!r})
        import importlib
        for mod in {mods!r} + ["chip_smoke"]:
            importlib.import_module(mod)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok", len({mods!r}) + 1)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_no_source_names_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|mammo_clip_tpu)(\s|\.|$)",
                     re.MULTILINE)
    offenders = [p for p in _sources() if pat.search(open(p).read())]
    assert not offenders, offenders


def test_cli_trains_and_resumes_without_host_extras(tmp_path):
    """cli/pretrain on the CPU at the tiny config's sizes, its config from the
    defaults and JSON-valued overrides (no --config: that needs PyYAML), then
    --resume; every module of BLOCKED is unimportable throughout."""
    code = textwrap.dedent(f"""
        import csv, json, os, sys, threading
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(1)  # a tiny model; other test processes share the cores
        from mammo_clip_tpu_torch.cli import pretrain
        work = {str(tmp_path)!r}
        path = os.path.join(work, "pretrain.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["patient_id", "image", "text", "fold"])
            for i in range(8):
                w.writerow([f"p{{i}}", str([f"i{{i}}.png"]), str([f"mass {{i}}."]), i % 4])
        entry = json.dumps([{{"csv": path, "image_dir": "synthetic://"}}])
        tiny = ["model.image_encoder.name=efficientnet-b0", "data.image_size_h=32",
                "data.image_size_w=32", "data.text_max_length=8",
                "model.text_encoder.num_layers=1", "model.text_encoder.hidden_size=16",
                "model.text_encoder.num_heads=2", "model.text_encoder.intermediate_size=32",
                "model.text_encoder.vocab_size=64", "model.projection_head.proj_dim=8",
                f"data.train={{entry}}", f"data.valid={{entry}}", "data.batch_size_per_device=2",
                "scheduler.warmup_epochs=0", "train.dtype=float32"]
        flags = ["--device", "cpu", "--workdir", os.path.join(work, "run"), "--variant", "b2"]
        state = pretrain.main(flags + tiny + ["scheduler.epochs=1"])
        assert state.step == 3, state.step
        state = pretrain.main(flags + ["--resume"] + tiny + ["scheduler.epochs=2"])
        assert state.step == 6, state.step
        assert threading.active_count() == 1, threading.enumerate()
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok", sorted(os.listdir(os.path.join(work, "run", "checkpoints"))))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok ['3', '6']"

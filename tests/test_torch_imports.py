"""Import hygiene of the port: it needs nothing beyond the standard library,
torch, numpy, scipy and einops (the card machine has no JAX, Flax, optax, Orbax,
yaml, transformers, PIL, pandas, scikit-learn or OpenCV), and no file of it
imports JAX or the JAX package. The pretraining CLI runs (and resumes), the
evaluation CLIs run on what it wrote, and the classifier, rescore and detector
CLIs run, with all of those blocked, as they must on the card."""

import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "mammo_clip_tpu_torch")
BLOCKED = ["jax", "jaxlib", "flax", "optax", "orbax", "yaml", "transformers", "PIL", "pandas",
           "sklearn", "cv2", "mammo_clip_tpu"]


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
                 "benchmarks.probe_mosaic", "benchmarks.layout_timing", "benchmarks.e6_timing",
                 "eval", "eval.metrics", "eval.retrieval", "eval.zeroshot", "eval.embeddings",
                 "eval.loading", "convert.torch_import", "convert.torch_export",
                 "cli.zeroshot", "cli.retrieval", "cli.validate", "parity.fake_checkpoint",
                 "parity.run_parity", "downstream", "downstream.classify",
                 "downstream.experiments", "losses.classification", "cli.classifier",
                 "cli.rescore", "ops.boxes", "ops.nms", "losses.focal", "models.retinanet",
                 "downstream.detect", "cli.detector"):
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
    --resume, then cli/validate, cli/zeroshot and cli/retrieval on the run;
    every module of BLOCKED is unimportable throughout."""
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
        # the evaluation entry points on that run
        from mammo_clip_tpu_torch.cli import retrieval, validate, zeroshot
        run = os.path.join(work, "run")
        summary = validate.main(["--workdir", run, "--device", "cpu"])
        assert sorted(summary["losses"]) == [3, 6], summary
        zs = os.path.join(work, "zs.csv")
        with open(zs, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["patient_id", "image_id", "Mass", "Suspicious_Calcification"])
            for i in range(6):
                w.writerow([f"p{{i}}", f"i{{i}}.png", i % 2, (i // 2) % 2])
        common = ["--checkpoint", run, "--image-dir", "synthetic://", "--device", "cpu"]
        assert set(zeroshot.main(common + ["--csv", zs])) == {{"mass", "suspicious_calcification"}}
        assert "Recall@1" in retrieval.main(common + ["--csv", path])["retrieval_i2t"]
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


def test_classifier_clis_run_without_host_extras(tmp_path):
    """cli/classifier (lp, then ft with --resume) on a tiny port CLIP
    checkpoint, then cli/rescore on its best/, with every module of BLOCKED
    unimportable."""
    code = textwrap.dedent(f"""
        import csv, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(1)
        from mammo_clip_tpu_torch.cli import classifier, rescore
        from mammo_clip_tpu_torch.core.config import tiny_test_config
        from mammo_clip_tpu_torch.models import build_model
        from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
        from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint
        work = {str(tmp_path)!r}
        cfg = tiny_test_config()
        cfg.data.image_size_h, cfg.data.image_size_w = 32, 32
        model = build_model(cfg.model.to_dict(), device="cpu")
        opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: 1e-4, model.named_parameters())
        save_checkpoint(os.path.join(work, "best"), create_train_state(model, opt),
                        config=cfg.to_dict(), step=1)
        path = os.path.join(work, "rsna.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["patient_id", "image_id", "laterality", "cancer", "fold"])
            for i in range(10):
                w.writerow([i // 2, f"i{{i}}.png", "LR"[i % 2], (i // 2) % 2, i % 2])
        for arch, extra in (("lp", ["--epochs", "1"]), ("ft", ["--epochs", "1"]),
                            ("ft", ["--epochs", "2", "--resume"])):
            res = classifier.main(["--clip-checkpoint", os.path.join(work, "best"),
                                   "--csv", path, "--image-dir", "synthetic://",
                                   "--arch", arch, "--batch-size", "2", "--device", "cpu",
                                   "--workdir", os.path.join(work, arch)] + extra)
        assert len(res["history"]) == 2, res
        scores = rescore.main(["--checkpoint", os.path.join(work, "ft", "best")])
        assert scores["n"] == 5, scores
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_detector_cli_runs_without_host_extras(tmp_path):
    """cli/detector (1 epoch, then --resume to 2 with multi-scale soft-NMS
    evaluation) on a tiny port CLIP checkpoint, with every module of BLOCKED
    unimportable; every validation image is scored."""
    code = textwrap.dedent(f"""
        import csv, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(1)
        from mammo_clip_tpu_torch.cli import detector
        from mammo_clip_tpu_torch.core.config import tiny_test_config
        from mammo_clip_tpu_torch.models import build_model
        from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
        from mammo_clip_tpu_torch.train.checkpoint import load_checkpoint_arrays, save_checkpoint
        work = {str(tmp_path)!r}
        cfg = tiny_test_config()
        model = build_model(cfg.model.to_dict(), device="cpu")
        opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: 1e-4, model.named_parameters())
        save_checkpoint(os.path.join(work, "best"), create_train_state(model, opt),
                        config=cfg.to_dict(), step=1)
        path = os.path.join(work, "det.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["study_id", "image_id", "finding_categories", "resized_xmin",
                        "resized_ymin", "resized_xmax", "resized_ymax", "split"])
            for i in range(7):
                w.writerow([f"s{{i}}", f"i{{i}}", str(["Mass"]), 4 + i, 6, 30 + i, 40,
                            "training" if i < 4 else "test"])
        flags = ["--clip-checkpoint", os.path.join(work, "best"), "--csv", path,
                 "--image-dir", "synthetic://", "--resize", "64", "--batch-size", "2",
                 "--device", "cpu", "--workdir", os.path.join(work, "det")]
        detector.main(flags + ["--epochs", "1"])
        res = detector.main(flags + ["--epochs", "2", "--resume", "--soft-nms",
                                     "--eval-scales", "1.0,1.5"])
        assert 0.0 <= res["best_mAP"] <= 1.0, res
        arrays = load_checkpoint_arrays(os.path.join(work, "det", "best"))
        assert arrays["scores"].shape[0] == 3, arrays["scores"].shape
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"

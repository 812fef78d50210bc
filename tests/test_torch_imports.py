"""Import hygiene of the port: it needs nothing beyond the standard library,
torch, numpy, scipy and einops (the card machine has no JAX, Flax, optax, Orbax,
yaml, transformers, PIL, pandas, scikit-learn, OpenCV or TensorBoard), and no
file of it imports JAX or the JAX package. The pretraining CLI runs (and
resumes, and seeds a flagship run from what it wrote; its metrics logger
writes the JSONL mirror alone), the evaluation and export CLIs run on what it
wrote, the classifier, rescore, detector and Mammo-FActOR CLIs run, and the offline
preprocessing (the DICOM tool, the PNG reader behind DirectoryImageStore, the
shard writer) runs, with all of those blocked, as they must on the card."""

import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "mammo_clip_tpu_torch")
BLOCKED = ["jax", "jaxlib", "flax", "optax", "orbax", "yaml", "transformers", "PIL", "pandas",
           "sklearn", "cv2", "tensorboard", "mammo_clip_tpu"]


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
                 "downstream.detect", "cli.detector", "data.png", "preprocess",
                 "preprocess.breast_crop", "preprocess.native_bindings",
                 "preprocess.dicom_native", "preprocess.dicom_tool", "preprocess.shard_writer",
                 "preprocess.text", "preprocess.vindr_csv", "convert.flagship_init",
                 "models.vit", "models.swin", "models.resnet", "interpret",
                 "interpret.factor", "cli.factor", "ops.quant", "utils.export",
                 "utils.profiling", "cli.export", "examples", "examples.get_embeddings",
                 "examples.downstream_classifier", "core.mesh", "ops.batchnorm",
                 "parallel", "parallel.shard_loss", "parallel.dryrun", "parallel.constraint",
                 "parallel.pipeline"):
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
    --resume, then cli/validate, cli/zeroshot, cli/retrieval and cli/export
    (its artifact loaded and called) on the run, then a flagship cli/pretrain
    with --warm-start-from the run's best/; every module of BLOCKED is
    unimportable throughout, TensorBoard too: the logger writes its JSONL
    mirror and no events."""
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
        assert os.path.exists(os.path.join(run, "metrics.jsonl"))
        assert not os.path.exists(os.path.join(run, "tensorboard"))
        from mammo_clip_tpu_torch.cli import export
        from mammo_clip_tpu_torch.utils.export import ServingModule
        served = os.path.join(work, "served")
        export.main(["--checkpoint", run, "--out", served, "--batch", "2", "--device", "cpu"])
        emb = ServingModule(served).embed_images(torch.zeros(2, 32, 32, 1))
        assert emb.shape == (2, 8) and bool(torch.isfinite(emb).all())
        # a flagship run seeded from that run's best/
        flags = ["--device", "cpu", "--workdir", os.path.join(work, "flag"), "--variant", "b2",
                 "--warm-start-from", os.path.join(run, "best")]
        state = pretrain.main(flags + tiny + ["scheduler.epochs=1",
                                              "model.image_encoder.tpu_optimized=true",
                                              "optimizer.warm_start_lr_scale=0.25"])
        assert state.step == 3 and hasattr(state.model.image_encoder, "tpu_stem_conv")
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


def test_factor_cli_runs_without_host_extras(tmp_path):
    """cli/factor (2 epochs of 2 steps) on a tiny port CLIP checkpoint whose
    image encoder is a Swin, with every module of BLOCKED unimportable."""
    code = textwrap.dedent(f"""
        import csv, json, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        torch.set_num_threads(1)
        from mammo_clip_tpu_torch.cli import factor
        from mammo_clip_tpu_torch.core.config import tiny_test_config
        from mammo_clip_tpu_torch.models import build_model
        from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
        from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint
        work = {str(tmp_path)!r}
        cfg = tiny_test_config()
        cfg.model.image_encoder = {{"name": "swin-tiny", "patch_size": 4, "embed_dim": 16,
                                    "depths": [1, 1], "num_heads": [2, 2], "window": 4}}
        model = build_model(cfg.model.to_dict(), device="cpu")
        opt = build_optimizer(cfg.optimizer.to_dict(), lambda s: 1e-4, model.named_parameters())
        save_checkpoint(os.path.join(work, "best"), create_train_state(model, opt),
                        config=cfg.to_dict(), step=1)
        path = os.path.join(work, "vindr.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["patient_id", "image_id", "Mass", "Suspicious_Calcification", "fold"])
            for i in range(10):
                w.writerow([f"p{{i}}", f"i{{i}}.png", i % 2, 1 - i % 2, int(i >= 2)])
        res = factor.main(["--clip-checkpoint", os.path.join(work, "best"), "--csv", path,
                           "--image-dir", "synthetic://", "--epochs", "2",
                           "--batch-size", "4", "--device", "cpu",
                           "--workdir", os.path.join(work, "factor")])
        assert res["final_loss"] == res["final_loss"], res  # finite, not NaN
        step = os.listdir(os.path.join(work, "factor", "mapper"))
        assert step == ["4"], step
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


def test_preprocessing_runs_without_host_extras(tmp_path):
    """The DICOM tool (shards with --bounds-csv through the pool, then --png),
    DirectoryImageStore on the PNG tree (with and without a resize) and the
    shard writer's default PNG loader, with every module of BLOCKED and pydicom
    unimportable. Without GDCM the DICOM part is replaced by PNGs of the raw
    arrays through the fused pipeline, and the run says so."""
    code = textwrap.dedent(f"""
        import os, sys
        for name in {BLOCKED!r} + ["pydicom"]:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from mammo_clip_tpu_torch.data.images import DirectoryImageStore, open_image_store
        from mammo_clip_tpu_torch.data.png import write_png
        from mammo_clip_tpu_torch.preprocess import dicom_native, dicom_tool, native_bindings
        from mammo_clip_tpu_torch.preprocess import write_packed_shards
        work = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        raws = []
        for i in range(3):
            raw = rng.integers(0, 200, (96, 72)).astype(np.uint16)
            raw[10:80, : 40 + 5 * i] += 3000 + rng.integers(0, 900, (70, 40 + 5 * i)).astype(
                np.uint16)
            raws.append(raw)
        pngs = os.path.join(work, "pngs", "study")
        os.makedirs(pngs)
        if dicom_native.dicom_available():
            os.makedirs(os.path.join(work, "dicoms"))
            for i, raw in enumerate(raws):
                dicom_native.write_dicom_u16(os.path.join(work, "dicoms", f"c{{i}}.dcm"), raw,
                                             ts=dicom_native.TS_J2K, monochrome1=i == 1)
            args = ["--in-dir", os.path.join(work, "dicoms"), "--height", "40", "--width", "32"]
            dicom_tool.main(args + ["--out-dir", os.path.join(work, "shards"),
                                    "--bounds-csv", os.path.join(work, "bounds.csv")])
            dicom_tool.main(args + ["--out-dir", pngs, "--png"])
            shards = open_image_store(os.path.join(work, "shards"))
            assert open(os.path.join(work, "bounds.csv")).readline() == "image_id,y0,y1,x0,x1\\n"
            mode = "dicom"
        else:
            for i, raw in enumerate(raws):
                write_png(os.path.join(pngs, f"c{{i}}.png"),
                          native_bindings.preprocess_mammogram_plain(raw[5:-5, 5:-5],
                                                                       (40, 32))[0])
            mode = "no GDCM"
        store = DirectoryImageStore(os.path.join(work, "pngs"))
        small = DirectoryImageStore(os.path.join(work, "pngs"), (20, 16))
        for i in range(3):
            img = store.get("study", f"c{{i}}.png")
            assert img.shape == (40, 32) and img.dtype == np.uint8 and img.max() > 100
            assert small.get("study", f"c{{i}}.png").shape == (20, 16)
            if mode == "dicom":
                np.testing.assert_array_equal(shards.get("", f"c{{i}}"), img)
        index = write_packed_shards([(f"c{{i}}", os.path.join(pngs, f"c{{i}}.png"))
                                     for i in range(3)], os.path.join(work, "from_png"),
                                    (20, 16), shard_size=2)
        assert [r["shard"] for r in index] == [0, 0, 1], index
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} + ["pydicom"]
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("ok", mode)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1].startswith("ok")


def test_sequence_and_pipeline_parallelism_run_without_host_extras():
    """The tiny BERT encoder with ``seq_parallel`` on two model ranks and the
    GPipe tower on four stages (threads of one process, ``ThreadGroup``), each
    against the whole encoder, with every module of BLOCKED unimportable."""
    code = textwrap.dedent(f"""
        import copy, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        from mammo_clip_tpu_torch.models.bert import BertConfig, BertEncoder
        from mammo_clip_tpu_torch.parallel import pipelined_bert_hidden
        from mammo_clip_tpu_torch.parallel.partitioning import place
        from mammo_clip_tpu_torch.parallel.tensor import ThreadGroup

        torch.manual_seed(0)
        enc = BertEncoder(BertConfig(vocab_size=64, hidden_size=16, num_layers=4, num_heads=2,
                                     intermediate_size=32, max_position_embeddings=32,
                                     dropout_rate=0.0, seq_parallel=True))
        for p in enc.parameters():
            p.data = 0.3 * torch.randn(p.shape)
        ids, mask = torch.randint(1, 64, (4, 8)), torch.ones(4, 8, dtype=torch.long)
        want = enc(ids, mask)
        sp = ThreadGroup(2)

        def model_rank(r):
            m = copy.deepcopy(enc)
            place(m, {{"model": sp.rank(r), "data": None}}, prefix="text_encoder")
            return m(ids, mask)

        pipe = ThreadGroup(4)
        stage = lambda r: pipelined_bert_hidden(copy.deepcopy(enc), ids, mask, pipe.rank(r),
                                                num_microbatches=2)
        for out in sp.run(model_rank) + pipe.run(stage):
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
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

"""The port's serving export (``utils/export.py``, ``cli/export.py``) against the
JAX package: a tiny CLIP (b0 and the 2-layer BERT) exported on the CPU and
loaded where the package cannot be imported, its embeddings held to JAX's
``embed_image`` / ``embed_text`` on the same weights (rtol 1e-4 / atol 1e-5, the
port's CLIP parity tolerance: same fp32 math, other summation orders); the CLI
from a port checkpoint; a tiny ViT exported on the CPU, whose graph holds the
plain attention and no operator of the package. Exporting on a card, where
the ViT's graph holds the flash kernel's operator, is checked by
tests/test_torch_cuda.py and chip_smoke.py phase 16."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from mammo_clip_tpu.models import build_model as jax_build_model
from mammo_clip_tpu_torch.cli import export as export_cli
from mammo_clip_tpu_torch.convert.from_jax import variables_from_state_dict
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train.checkpoint import save_checkpoint
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule
from mammo_clip_tpu_torch.utils.export import (
    ServingModule,
    export_clip_serving,
    package_operators,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT_PY = os.path.join(ROOT, "mammo_clip_tpu_torch", "utils", "export.py")
TINY_VIT = {"name": "vit-tiny", "patch_size": 8, "hidden_size": 32, "num_layers": 2,
            "num_heads": 2, "mlp_dim": 64, "base_grid": 4}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel processes, and
    torch's default of one thread per core in each oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(image_encoder=None, seed=5):
    cfg = tiny_test_config()
    if image_encoder:
        cfg.model.image_encoder = image_encoder
    model = build_model(cfg.model.to_dict(), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return model.eval(), cfg


def _inputs(cfg, n=2, seed=3):
    rng = np.random.default_rng(seed)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    ids = rng.integers(1, cfg.model.text_encoder.vocab_size, size=(n, s)).astype(np.int32)
    lengths = rng.integers(2, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return rng.standard_normal((n, h, w, 1)).astype(np.float32), ids * mask, mask


def _serve_in_a_bare_process(out_dir, images, ids, mask, tmp_path):
    """Load the artifact with ``ServingModule`` from utils/export.py's file, in a
    process where this package, JAX and the JAX package cannot be imported;
    return its embeddings and the package modules it loaded."""
    for name, arr in (("images", images), ("ids", ids), ("mask", mask)):
        np.save(tmp_path / f"{name}.npy", arr)
    code = textwrap.dedent(f"""
        import importlib.util, json, sys
        for name in ("mammo_clip_tpu_torch", "mammo_clip_tpu", "jax", "jaxlib"):
            sys.modules[name] = None
        import numpy as np, torch
        spec = importlib.util.spec_from_file_location("serving_export", {EXPORT_PY!r})
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        srv = mod.ServingModule({str(out_dir)!r})
        d = {str(tmp_path)!r}
        img = srv.embed_images(torch.from_numpy(np.load(d + "/images.npy")))
        txt = srv.embed_texts(torch.from_numpy(np.load(d + "/ids.npy")),
                              torch.from_numpy(np.load(d + "/mask.npy")))
        np.save(d + "/img_emb.npy", img.numpy())
        np.save(d + "/txt_emb.npy", txt.numpy())
        print(json.dumps(sorted(m for m in sys.modules if m.startswith(("mammo_clip", "jax"))
                                and sys.modules[m] is not None)))
    """)
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    return np.load(tmp_path / "img_emb.npy"), np.load(tmp_path / "txt_emb.npy"), loaded


def test_cpu_artifact_embeds_as_jax_without_the_package(tmp_path):
    model, cfg = _model()
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    out = tmp_path / "serving"
    files = export_clip_serving(model, (h, w), s, batch=2, out_dir=str(out))
    assert set(files) == {"image_fn.cpu", "text_fn.cpu", "manifest"}
    manifest = json.loads((out / "serving.json").read_text())
    assert manifest == {"image_input": [2, h, w, 1], "text_input": [2, s],
                        "embedding_dim": cfg.model.projection_head.proj_dim,
                        "platforms": ["cpu"], "contract": manifest["contract"],
                        "requires": {"cpu": []}}
    assert not model.training
    # each program keeps only its own tower's parameters (and the scalar logit_scale)
    towers = {k: {n.split(".")[1] for n in torch.export.load(files[k]).state_dict}
              for k in ("image_fn.cpu", "text_fn.cpu")}
    assert towers == {"image_fn.cpu": {"image_encoder", "image_projection", "logit_scale"},
                      "text_fn.cpu": {"text_encoder", "text_projection", "logit_scale"}}
    assert sorted(model._modules) == ["image_encoder", "image_projection", "text_encoder",
                                      "text_projection"]

    images, ids, mask = _inputs(cfg)
    img, txt, loaded = _serve_in_a_bare_process(out, images, ids, mask, tmp_path)
    assert loaded == []
    jm = jax_build_model(cfg.model.to_dict())
    v = variables_from_state_dict(model.state_dict())
    want_img = jax.jit(lambda v, x: jm.apply(v, x, train=False, method=jm.embed_image))(
        v, images)
    want_txt = jax.jit(lambda v, i, m: jm.apply(v, i, m, train=False, method=jm.embed_text))(
        v, ids, mask)
    np.testing.assert_allclose(img, np.asarray(want_img), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(txt, np.asarray(want_txt), rtol=1e-4, atol=1e-5)


def test_export_cli_from_a_port_checkpoint(tmp_path, capsys):
    model, cfg = _model(seed=6)
    opt = build_optimizer(cfg.optimizer.to_dict(), warmup_cosine_sq_schedule(1e-4, 10, 1),
                          model.named_parameters())
    run = tmp_path / "run"
    save_checkpoint(str(run / "checkpoints"), create_train_state(model, opt),
                    config=cfg.to_dict(), step=1)
    out = tmp_path / "serving"
    res = export_cli.main(["--checkpoint", str(run), "--out", str(out), "--batch", "3",
                           "--text-len", "12", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))
    assert res["batch"] == 3 and res["text_len"] == 12
    assert res["image_size"] == [cfg.data.image_size_h, cfg.data.image_size_w]
    srv = ServingModule(str(out))
    images, ids, mask = _inputs(cfg, n=3, seed=4)
    ids, mask = ids[:, :12], mask[:, :12]
    with torch.no_grad():
        want_img = model.embed_image(torch.from_numpy(images))
        want_txt = model.embed_text(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(srv.embed_images(torch.from_numpy(images)).numpy(),
                               want_img.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(srv.embed_texts(torch.from_numpy(ids), torch.from_numpy(mask))
                               .numpy(), want_txt.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="cuda"):
        ServingModule(str(out), device="cuda")


def test_vit_exported_on_the_cpu_holds_no_operator_of_the_package(tmp_path):
    """On the CPU the ViT's attention is the plain version: the traced graph
    calls no operator of the package, and ``requires`` is empty."""
    model, cfg = _model(TINY_VIT)
    h, w, s = cfg.data.image_size_h, cfg.data.image_size_w, cfg.data.text_max_length
    x = torch.zeros(2, h, w, 1)
    program = torch.export.export(_Embed(model), (x,))
    assert package_operators(program) == set()
    assert not any("flash" in str(n.target) for n in program.graph.nodes)
    out = tmp_path / "serving"
    export_clip_serving(model, (h, w), s, batch=2, out_dir=str(out))
    assert json.loads((out / "serving.json").read_text())["requires"] == {"cpu": []}
    images = torch.from_numpy(_inputs(cfg)[0])
    with torch.no_grad():
        want = model.embed_image(images)
    np.testing.assert_allclose(ServingModule(str(out)).embed_images(images).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-6)


class _Embed(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model.embed_image(x, train=False)

"""The port's checkpoint converters (``convert/torch_import.py``,
``convert/torch_export.py``) and its fake of the public ``.tar``
(``parity/fake_checkpoint.py``) on the CPU against the JAX package's.

* import: on one ``.tar`` from the JAX package's ``parity/fake_checkpoint.py``
  (b2, 128x96, 24 tokens; built once for the module, and no model of the JAX
  package runs on it) both importers give the same tree, leaf for leaf
  (bit-equal values, same dtypes), the same embedded config and the same
  mapped config; ``load_clip_for_eval`` loads that tree into the port's model;
* round trip: the port's export read by the JAX importer, and the JAX export
  read by the port's importer, give back the original tree bit for bit;
* the port's fake ``.tar``: the same keys, shapes, dtypes, config and
  metadata as the JAX package's, for b2 and b5 (b5 not written to disk);
* an embedded config that is not a plain mapping raises.
"""

import pickle
import sys
import types

import numpy as np
import pytest
import torch

from mammo_clip_tpu.convert import torch_export as jax_export
from mammo_clip_tpu.convert import torch_import as jax_import
from mammo_clip_tpu.eval.loading import _reference_config_to_ours as jax_reference_config
from mammo_clip_tpu_torch.convert import torch_export, torch_import
from mammo_clip_tpu_torch.convert.from_jax import state_dict_from_jax, variables_from_state_dict
from mammo_clip_tpu_torch.core.config import tiny_test_config
from mammo_clip_tpu_torch.eval.loading import _reference_config_to_ours, load_clip_for_eval
from mammo_clip_tpu_torch.models import build_model
from mammo_clip_tpu_torch.parity import fake_checkpoint
from parity import fake_checkpoint as jax_fake


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


@pytest.fixture(scope="module")
def jax_b2_tar(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers' torch BERT only; TensorFlow is not needed
        path = str(tmp_path_factory.mktemp("ref") / "b2-model-best-epoch-10.tar")
        return jax_fake.make_fake_public_tar(path, variant="b2", image_hw=(128, 96),
                                             text_max_length=24)


def test_import_matches_jax(jax_b2_tar):
    got, got_cfg = torch_import.convert_clip_checkpoint(jax_b2_tar)
    want, want_cfg = jax_import.convert_clip_checkpoint(jax_b2_tar)
    _assert_same_tree(got, want)
    assert got_cfg == want_cfg
    ours = _reference_config_to_ours(got_cfg)
    assert ours.to_dict() == jax_reference_config(want_cfg).to_dict()
    assert ours.model.image_encoder.name == "tf_efficientnetv2-detect"
    assert (ours.data.image_size_h, ours.data.image_size_w, ours.data.text_max_length) == \
        (128, 96, 24)

    model, cfg = load_clip_for_eval(jax_b2_tar, device="cpu")
    assert cfg.to_dict() == ours.to_dict()
    sd = model.state_dict()
    for name, t in state_dict_from_jax(want).items():
        assert torch.equal(sd[name], t), name
    with pytest.raises(ValueError, match="no EMA"):
        load_clip_for_eval(jax_b2_tar, use_ema=True, device="cpu")


@pytest.fixture(scope="module")
def tiny_state_dict():
    cfg = tiny_test_config()
    gen = torch.Generator().manual_seed(3)
    model = build_model(cfg.model.to_dict(), device="cpu", generator=gen)
    with torch.no_grad():  # running statistics that are not the init's
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=gen) + (0.5 if name.endswith("var") else 0.0))
    return model.state_dict()


def test_state_dict_and_tree_are_inverse(tiny_state_dict):
    tree = variables_from_state_dict(tiny_state_dict)
    back = state_dict_from_jax(tree)
    assert set(back) == set(tiny_state_dict)
    for k, t in tiny_state_dict.items():
        assert torch.equal(back[k], t), k


@pytest.mark.parametrize("direction", ["port_export_jax_import", "jax_export_port_import"])
def test_round_trip(tiny_state_dict, direction, tmp_path):
    tree = variables_from_state_dict(tiny_state_dict)
    heads = tiny_test_config().model.text_encoder.num_heads
    if direction == "port_export_jax_import":
        path = str(tmp_path / "port.tar")
        torch_export.export_clip_checkpoint(tiny_state_dict, path, config={"k": 1}, epoch=2)
        back, cfg = jax_import.convert_clip_checkpoint(path, num_heads=heads)
        ref = torch_export.export_state_dict(tiny_state_dict)
        assert cfg == {"k": 1}
    else:
        path = str(tmp_path / "jax.tar")
        jax_export.export_clip_checkpoint(tree, path, config={"k": 1}, epoch=2)
        back, cfg = torch_import.convert_clip_checkpoint(path, num_heads=heads)
        ref = jax_export.export_state_dict(tree)
        assert cfg == {"k": 1}
    _assert_same_tree(back, tree)
    # both exporters write the same reference-named tensors
    other = (jax_export.export_state_dict(tree) if direction == "port_export_jax_import"
             else torch_export.export_state_dict(tiny_state_dict))
    assert list(ref) == list(other)
    for k in ref:
        assert torch.equal(ref[k], other[k]), k


def _jax_payload(variant, monkeypatch):
    """The JAX package's fake payload, captured instead of written."""
    captured = {}
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setattr(torch, "save", lambda obj, path: captured.setdefault("payload", obj))
    jax_fake.make_fake_public_tar("unused.tar", variant=variant, image_hw=(1520, 912),
                                  text_max_length=256)
    return captured["payload"]


@pytest.mark.parametrize("variant", ["b2", "b5"])
def test_fake_payload_matches_jax(variant, monkeypatch):
    want = _jax_payload(variant, monkeypatch)
    monkeypatch.undo()
    got = fake_checkpoint.fake_public_payload(variant, image_hw=(1520, 912), text_max_length=256)
    assert list(got["model"]) == list(want["model"])
    for k, w in want["model"].items():
        g = got["model"][k]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), k
    assert {k: v for k, v in got.items() if k != "model"} == \
        {k: v for k, v in want.items() if k != "model"}


def test_fake_tar_imports_like_jax(tmp_path):
    """The port's fake ``.tar`` on disk through both importers."""
    path = fake_checkpoint.make_fake_public_tar(str(tmp_path / "b2.tar"), variant="b2")
    got, got_cfg = torch_import.convert_clip_checkpoint(path)
    want, want_cfg = jax_import.convert_clip_checkpoint(path)
    _assert_same_tree(got, want)
    assert got_cfg == want_cfg


def test_embedded_config_must_be_a_mapping(tiny_state_dict, tmp_path, monkeypatch):
    sd = torch_export.export_state_dict(tiny_state_dict)
    path = str(tmp_path / "ns.tar")
    torch.save({"model": sd, "config": types.SimpleNamespace(model={})}, path)
    with pytest.raises(TypeError, match="not a plain mapping"):
        torch_import.convert_clip_checkpoint(path, num_heads=2)

    # a config object whose module is not installed (as an OmegaConf object
    # without omegaconf): the pickle names a module that the loader cannot import
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "cfgmod_not_installed.py").write_text("class DictConfig(dict):\n    pass\n")
    monkeypatch.syspath_prepend(str(mod_dir))
    import cfgmod_not_installed

    path = str(tmp_path / "omega.tar")
    torch.save({"model": sd, "config": cfgmod_not_installed.DictConfig(model={})}, path,
               pickle_module=pickle)
    monkeypatch.delitem(sys.modules, "cfgmod_not_installed")
    sys.path.remove(str(mod_dir))  # monkeypatch restores sys.path afterwards
    with pytest.raises(RuntimeError, match="cfgmod_not_installed"):
        torch_import.convert_clip_checkpoint(path, num_heads=2)

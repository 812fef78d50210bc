"""The port's pretraining entry point (cli/pretrain -> Trainer -> checkpoint ->
resume) on the CPU, at the tiny config (b0 at 64x64, 2-layer BERT).

Against the JAX package: one epoch of ``cli/pretrain`` from the same initial
parameters (the JAX tree carried across with convert/from_jax.py) and the same
CSV, with augmentation, dropout and drop-connect off and fp32 activations; the
per-step training losses agree to 1e-4 relative and 1e-5 absolute, the
parameters to 1e-5 absolute and the BatchNorm statistics to 1e-4 (fp32 through ~30 layers in another summation order: the tolerances
and the AdamW eps of 1e-3 of tests/test_torch_train.py, for its reasons).
The JAX CLI runs on the 8-device CPU mesh with 1 sample per device, the port
on one device with 8. Gradient accumulation with the EMA is held to the JAX
TrainState over optax.MultiSteps at the AdamW test's tolerance (rtol 1e-5,
atol 1e-7: torch and optax round the AdamW update differently in the last bit).

The port alone: a resumed run is bit-exact against an uninterrupted one
(across an epoch boundary and from a SIGTERM flush inside an epoch),
steps_per_call=2 equals 1, a resume keeps a better best/, and no thread is left
behind.
"""

import dataclasses
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import mammo_clip_tpu.models.clip as jax_clip
from mammo_clip_tpu.cli import pretrain as jax_pretrain
from mammo_clip_tpu.core.config import tiny_test_config as jax_tiny_config
from mammo_clip_tpu.train import build_optimizer as jax_build_optimizer
from mammo_clip_tpu.train import trainer as jax_trainer
from mammo_clip_tpu.train.schedule import warmup_cosine_sq_schedule as jax_schedule
from mammo_clip_tpu.train.state import TrainState as JaxTrainState
from mammo_clip_tpu.train.state import create_train_state as jax_create_train_state
from mammo_clip_tpu_torch.cli import pretrain
from mammo_clip_tpu_torch.convert.from_jax import load_jax_variables, state_dict_from_jax
from mammo_clip_tpu_torch.core.config import save_config, tiny_test_config
from mammo_clip_tpu_torch.train import build_optimizer, create_train_state
from mammo_clip_tpu_torch.train import trainer as trainer_mod
from mammo_clip_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from mammo_clip_tpu_torch.train.schedule import warmup_cosine_sq_schedule


def _write_csv(path, n, valid_from=None):
    """n patient rows; fold i % 4, or with ``valid_from`` fold 0 (valid) from that row on."""
    pd.DataFrame([{
        "patient_id": f"p{i}", "laterality": "L",
        "image": str([f"i{i}a.png", f"i{i}b.png"]), "view": str(["CC", "MLO"]),
        "CC": str([f"i{i}a.png"]), "MLO": str([f"i{i}b.png"]),
        "text": str([f"there is a mass in sample {i}.", f"impression {i}."]),
        "text_augment": str([f"a mass in sample {i}.", f"imp {i}."]),
        "fold": (i % 4 if valid_from is None else int(i < valid_from)),
    } for i in range(n)]).to_csv(path, index=False)


def _config(csv, batch, epochs=1, **train):
    """The tiny config made deterministic: no augmentation, dropout or drop-connect."""
    cfg = tiny_test_config()
    entry = {"csv": str(csv), "image_dir": "synthetic://", "data_type": "imagetext"}
    cfg.data.update(train=[entry], valid=[entry], batch_size_per_device=batch)
    cfg.scheduler.update(epochs=epochs, warmup_epochs=0)
    cfg.train.update(dtype="float32", log_every=1, **train)
    cfg.optimizer.eps = 1e-3
    cfg.model.image_encoder.drop_connect_rate = 0.0
    cfg.model.text_encoder.dropout_rate = 0.0
    cfg.model.projection_head.dropout = 0.0
    for k in ("hflip_p", "vflip_p", "affine_p", "elastic_p"):
        cfg.augment[k] = 0.0
    return cfg


def _threads_left():
    return [t.name for t in threading.enumerate() if t is not threading.main_thread()
            and (not t.daemon or t.name == "prefetch_to_device")]


def _run(cfg, workdir, *flags):
    path = os.path.join(os.path.dirname(workdir), os.path.basename(workdir) + ".yaml")
    save_config(cfg, path)
    state = pretrain.main(["--config", path, "--workdir", workdir, "--device", "cpu", *flags])
    assert not _threads_left()
    return state


def _metrics(workdir, prefix):
    rows = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    return [r for r in rows if r["prefix"] == prefix]


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.inner.state_dict()["state"], b.optimizer.inner.state_dict()["state"]
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert a.step == b.step and a.optimizer.count == b.optimizer.count


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and the suite runs
    several worker processes at once: one thread each keeps them from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def csv16(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "pretrain.csv"
    _write_csv(path, 16)  # 12 train rows (folds 1-3), 4 valid rows (fold 0)
    return path


# ---------------------------------------------------------------- against JAX


def test_cli_epoch_matches_jax(tmp_path, monkeypatch):
    """One epoch of each package's CLI: the training loss of its step, and every
    parameter and BatchNorm statistic at the end. The epoch is one step of 8
    samples without validation, and the JAX end state is read where its trainer
    saves it, not written: on one CPU core each further JAX step, the eval
    step's compile and the Orbax write each add 30-50 s."""
    csv = tmp_path / "pretrain.csv"
    _write_csv(csv, 8, valid_from=8)  # 8 train rows -> 1 step
    jcfg = jax_tiny_config()
    ours_cfg = _config(csv, batch=8)
    del ours_cfg.data["valid"]
    for k, v in ours_cfg.to_dict().items():
        jcfg[k] = v
    jcfg.data.batch_size_per_device = 1  # x 8 CPU devices = 8 per step
    jpath = tmp_path / "jax.yaml"
    save_config(jcfg, str(jpath))

    orig = jax_clip.bert_config_from_model_config
    monkeypatch.setattr(jax_clip, "bert_config_from_model_config",
                        lambda mc: dataclasses.replace(orig(mc), dropout_rate=0.0))
    seen = {}

    def variables_of(state):
        return jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                   "batch_stats": state.batch_stats})

    def create(*a, **k):  # the JAX Trainer's initial variables
        state = jax_create_train_state(*a, **k)
        seen["init"] = variables_of(state)
        return state

    def save(directory, state, *a, **k):  # its variables at the end of the epoch
        seen["final"] = variables_of(state)

    monkeypatch.setattr(jax_trainer, "create_train_state", create)
    monkeypatch.setattr(jax_trainer, "save_checkpoint", save)
    jwork = str(tmp_path / "jax_run")
    jax_pretrain.main(["--config", str(jpath), "--workdir", jwork])

    build = trainer_mod.build_model

    def build_from_jax(*a, **k):
        m = build(*a, **k)
        load_jax_variables(m, seen["init"])
        return m

    monkeypatch.setattr(trainer_mod, "build_model", build_from_jax)
    work = str(tmp_path / "run")
    state = _run(ours_cfg, work)
    assert state.step == 1
    ours, ref = _metrics(work, "train"), _metrics(jwork, "train")
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [1]
    for key in [k for k in ref[0] if k.startswith("loss/")]:
        np.testing.assert_allclose(ours[0][key], ref[0][key], rtol=1e-4, atol=1e-5, err_msg=key)
    want = state_dict_from_jax(seen["final"])
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        tol = dict(rtol=1e-4, atol=1e-5) if k.endswith(("mean", "var")) else dict(rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)


def test_grad_accum_with_ema_matches_jax():
    """grad_accum_steps=2 (optax.MultiSteps) with an EMA of decay 0.9: the EMA is
    blended only on the micro-step that completes a group."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "bias": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(6)]
    opt_cfg = {"name": "adamw", "weight_decay": 0.1, "grad_clip_norm": 1.0,
               "grad_accum_steps": 2}
    tx = jax_build_optimizer(opt_cfg, jax_schedule(1e-2, 10, 1))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.asarray(0), params=jp, batch_stats={}, opt_state=tx.init(jp),
                           tx=tx, ema_params=jax.tree_util.tree_map(jnp.copy, jp),
                           ema_decay=0.9)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    opt = build_optimizer(opt_cfg, warmup_cosine_sq_schedule(1e-2, 10, 1),
                          module.named_parameters())
    state = create_train_state(module, opt, ema_decay=0.9)
    for i, g in enumerate(grads):
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, g))
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k])
        state.apply_gradients()
        assert state.step == i + 1 and opt.count == (i + 1) // 2
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} step {i}")
            np.testing.assert_allclose(state.ema[k].numpy(), np.asarray(jstate.ema_params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"ema {k} step {i}")


# ---------------------------------------------------------------- the port alone


class _Killed(Exception):
    pass


def test_resume_across_an_epoch_is_bit_exact(tmp_path, csv16, monkeypatch):
    """2 epochs straight == 1 epoch, the process dying as epoch 2 starts,
    then --resume for epoch 2."""
    cfg = _config(csv16, batch=4, epochs=2)
    straight = _run(cfg, str(tmp_path / "a"))
    assert straight.step == 6

    real = pretrain.prefetch_to_device
    calls = []

    def dies_at_epoch_2(*a, **k):  # train(0), valid(0), then train(1)
        calls.append(1)
        if len(calls) == 3:
            raise _Killed
        return real(*a, **k)

    monkeypatch.setattr(pretrain, "prefetch_to_device", dies_at_epoch_2)
    with pytest.raises(_Killed):
        _run(cfg, str(tmp_path / "b"))
    monkeypatch.setattr(pretrain, "prefetch_to_device", real)
    resumed = _run(cfg, str(tmp_path / "b"), "--resume")
    _assert_states_equal(resumed, straight)
    assert [r["step"] for r in _metrics(str(tmp_path / "b"), "train")] == [1, 2, 3, 4, 5, 6]
    meta = json.load(open(tmp_path / "b" / "checkpoints" / "6" / "meta.json"))
    assert meta["epoch"] == 2 and not meta.get("preempted")
    assert os.path.exists(tmp_path / "b" / "checkpoints" / "6" / "config.json")


@pytest.mark.parametrize("k_steps,stop_at", [(1, 2), (2, 2)])
def test_sigterm_mid_epoch_resume_is_bit_exact(tmp_path, csv16, monkeypatch, k_steps, stop_at):
    """SIGTERM during a step inside epoch 1 flushes a preempted checkpoint and
    returns; --resume skips the trained batches and ends equal to a run that was
    never stopped. The old SIGTERM handler is back afterwards."""
    cfg = _config(csv16, batch=2, epochs=1, steps_per_call=k_steps)
    straight = _run(cfg, str(tmp_path / "a"))
    assert straight.step == 6

    real = pretrain.prefetch_to_device

    def term_during_step(batches, *a, **k):
        for i, b in enumerate(real(batches, *a, **k)):
            if k.get("stacked") is not None and i == stop_at // k_steps - 1:
                signal.raise_signal(signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(pretrain, "prefetch_to_device", term_during_step)
    stopped = _run(cfg, str(tmp_path / "b"))
    monkeypatch.setattr(pretrain, "prefetch_to_device", real)
    assert signal.getsignal(signal.SIGTERM) is before
    assert stopped.step == stop_at
    meta = json.load(open(tmp_path / "b" / "checkpoints" / str(stop_at) / "meta.json"))
    assert meta["preempted"] and meta["epoch"] == 0
    resumed = _run(cfg, str(tmp_path / "b"), "--resume")
    _assert_states_equal(resumed, straight)


def test_steps_per_call_2_equals_1(tmp_path, csv16):
    one = _run(_config(csv16, batch=3, epochs=1), str(tmp_path / "k1"))
    two = _run(_config(csv16, batch=3, epochs=1, steps_per_call=2), str(tmp_path / "k2"))
    assert one.step == two.step == 4
    _assert_states_equal(one, two)
    assert [r["step"] for r in _metrics(str(tmp_path / "k2"), "train")] == [2, 4]


def test_resume_keeps_a_better_best(tmp_path, csv16):
    """A resumed run restores best_val: a worse epoch does not overwrite best/."""
    work = str(tmp_path / "run")
    _run(_config(csv16, batch=4, epochs=1), work)
    meta_path = tmp_path / "run" / "checkpoints" / "3" / "meta.json"
    meta = json.load(open(meta_path))
    assert meta["best_val"] is not None
    meta["best_val"] = -1e9  # pretend the pre-preemption best was unbeatable
    json.dump(meta, open(meta_path, "w"))
    _run(_config(csv16, batch=4, epochs=2), work, "--resume")
    assert os.listdir(tmp_path / "run" / "best") == ["3"]
    assert json.load(open(tmp_path / "run" / "best" / "3" / "meta.json"))["epoch"] == 1


def test_trainer_guards_and_profile(tmp_path, csv16):
    """Warm start from a missing checkpoint raises; an epoch shorter than
    steps_per_call raises; a misaligned preempted resume raises;
    profile_at_step writes a trace."""
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        _run(_config(csv16, batch=4, epochs=1), str(tmp_path / "warm"), "--warm-start-from",
             str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="fewer batches"):
        _run(_config(csv16, batch=12, epochs=1, steps_per_call=2), str(tmp_path / "short"))
    work = str(tmp_path / "prof")
    state = _run(_config(csv16, batch=4, epochs=1, profile_at_step=1, profile_num_steps=1),
                 work)
    assert os.path.exists(os.path.join(work, "profile", "trace_step1.json"))
    save_checkpoint(os.path.join(work, "checkpoints"), state, step=9,  # the latest, at step 3
                    extra_meta={"epoch": 0, "preempted": True})
    with pytest.raises(ValueError, match="not aligned"):
        _run(_config(csv16, batch=4, epochs=1, steps_per_call=2), work, "--resume")


def test_checkpoint_round_trip_and_ema_seeding(tmp_path):
    """The payload restores model, buffers, optimizer, step and generator state;
    a state tracking an EMA restored from a checkpoint without one seeds it from
    the restored parameters; max_to_keep prunes the oldest steps."""
    def make(ema):
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
        opt = build_optimizer({"name": "adamw"}, lambda s: 1e-2, m.named_parameters())
        return create_train_state(m, opt, ema_decay=ema)

    a = make(0.0)
    for _ in range(2):
        a.model(torch.randn(4, 3)).sum().backward()
        a.apply_gradients()
    gen = torch.Generator().manual_seed(5)
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), a, step=step, config={"seed": 1}, max_to_keep=2,
                        generators={"step": gen})
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    b = make(0.5)
    gen_b = torch.Generator()
    b, config, meta = restore_checkpoint(str(tmp_path), b, generators={"step": gen_b})
    assert meta == {"step": 3} and config == {"seed": 1} and b.step == 2
    _assert_states_equal(b, a)
    for name, p in b.model.named_parameters():
        assert torch.equal(b.ema[name], p)
    assert torch.equal(gen_b.get_state(), gen.get_state())
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), b)

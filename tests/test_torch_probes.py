"""The functions of benchmarks/probe_mosaic.py's TPU probes in the port
(mammo_clip_tpu_torch/ops/probes.py and benchmarks/probe_mosaic.py).

Layout probes: the JAX script runs here under
``pltpu.force_tpu_interpret_mode()`` (about 2 s) and prints one line per probe;
the port's script on the CPU prints the same names and shapes and the same
sums, to the print's resolution (3 decimals) and 1e-5 relative (fp32 sums in
another order). The JAX ``dot_3d`` probe fails (fault R6: it contracts w's
channels with x's rows); the port's ``channel_mix`` computes what its docstring
means and is held to a numpy einsum.

Grid probes: the four functions of ``probe_grid_overhead`` against numpy
versions of their formulas at a small shape (N=2, C=4, E=8, H=32, W=24): sums in
float64 against the port's fp32, within 1e-5 of the largest entry; the compute
chain rounds z, SiLU and each tap product to bf16 on both sides (numpy through
float32 bit rounding), within 1e-3 (a rounding tie may flip one ulp). The base,
halo and const functions are also held to the JAX script's own Pallas kernels,
run once each under ``pltpu.force_tpu_interpret_mode()`` at the probe's full
seeded inputs, within 1e-5 of the largest entry (fp32 sums in another order;
the const sums are ~3e8, where fp32 resolves ~30).
"""

import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mammo_clip_tpu_torch.benchmarks import probe_mosaic as port_probe
from mammo_clip_tpu_torch.ops import probes


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """1 intra-op thread: the suite runs its files in parallel
    processes, and torch's default of one thread per core in each oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = ["concat_aligned", "reshape_collapse", "reshape_split", "sublane_stack", "dot_3d",
          "reshape_collapse_rows10", "reshape_split_rows10"]
LINE = re.compile(r"PROBE (\w+): (OK|FAIL) ?(\([\d, ]+\))? ?(?:sum=(-?[\d.]+))?")


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location(
        "_jax_probe_mosaic", os.path.join(ROOT, "benchmarks", "probe_mosaic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text):
    out = {}
    for line in text.splitlines():
        m = LINE.match(line)
        assert m, line
        out[m.group(1)] = m.groups()[1:]
    return out


@pytest.fixture(scope="module")
def jax_lines():
    """What the JAX script prints for the layout probes (interpret mode)."""
    import contextlib
    import io

    jax_probe = _load_jax_probe()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pltpu.force_tpu_interpret_mode():
        for name in LAYOUT:
            jax_probe.PROBES[name]()
    return _lines(buf.getvalue())


def test_layout_probes_print_what_the_jax_script_prints(jax_lines, capsys):
    res = port_probe.main(LAYOUT + ["--device", "cpu"])
    ours = _lines(capsys.readouterr().out)
    assert list(ours) == list(jax_lines)
    for name, (status, shape, total) in ours.items():
        assert status == "OK", name
        if name == "dot_3d_rank3rhs":
            continue
        assert jax_lines[name][:2] == (status, shape), name
        assert abs(float(total) - float(jax_lines[name][2])) <= 1e-5 * abs(float(total)) + 2e-3
    assert set(res) == set(LAYOUT)


def test_jax_dot_3d_probe_fails_and_the_port_computes_its_intended_function(jax_lines):
    """R6: the JAX probe contracts w's axis 0 (C=16) with x's axis 1 (H=8)."""
    status, _, _ = jax_lines["dot_3d_rank3rhs"]
    assert status == "FAIL"
    x = np.random.default_rng(0).standard_normal((16, 8, 384)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32)
    got = port_probe.probe_dot_3d_batch("cpu")
    assert tuple(got.shape) == (8, 16, 384)
    np.testing.assert_allclose(got.numpy(), np.einsum("chw,cd->hdw", x, w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(probes.channel_mix(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.einsum("chw,cd->hdw", x, w), rtol=1e-5, atol=1e-5)


def test_layout_functions_match_numpy():
    r = np.random.default_rng(4)
    x = r.standard_normal((5, 3, 12)).astype(np.float32)
    flat = x[..., :10].reshape(5, -1).astype(np.float64)
    np.testing.assert_allclose(probes.gram_rows(torch.from_numpy(x), 10).numpy(), flat @ flat.T,
                               rtol=1e-5, atol=1e-5)
    got = probes.copy_scale(torch.from_numpy(x), (5, 36), 2.0)
    np.testing.assert_array_equal(got.numpy(), (2 * x).reshape(5, 36))
    with pytest.raises(ValueError):
        probes.copy_scale(torch.from_numpy(x), (5, 35))
    with pytest.raises(ValueError):
        probes.gram_rows(torch.from_numpy(x), 13)


def _bf16(a):
    """Round float32 values to bfloat16 (to nearest even), kept as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _np_grid(x, k, vec, we):
    """Rows 4-7 of the probe table in numpy (float64 sums, bf16 roundings in the chain)."""
    N, C, H, W = x.shape
    ntl = H // 8
    xd = x.astype(np.float64)
    base = xd.sum((0, 2, 3))
    i = np.arange(ntl)
    top, bot = 8 * np.maximum(i - 1, 0) + 7, 8 * np.minimum(i + 1, ntl - 1)
    halo = base + 8 * (xd[:, :, top].sum((0, 2, 3)) + xd[:, :, bot].sum((0, 2, 3)))
    const = base + N * ntl * 8 * W * (k[:, 0, :].astype(np.float64).sum() + vec.sum())
    z = _bf16(np.einsum("ce,nchw->nehw", we.astype(np.float64), xd))
    s = _bf16(z.astype(np.float64) / (1 + np.exp(-z.astype(np.float64))))
    pad = np.pad(s, ((0, 0), (0, 0), (0, 0), (1, 1)))
    d = np.zeros(z.shape, np.float32)
    for a in range(3):
        for b in range(3):
            d = d + _bf16(pad[..., b:b + W] * k[None, :, 3 * a + b, None, :])
    compute = d[:, :C].astype(np.float64).sum((0, 2, 3))
    return base, halo, const, compute


def test_grid_functions_match_numpy_formulas():
    N, C, E, H, W = 2, 4, 8, 32, 24
    r = np.random.default_rng(5)
    arrays = [_bf16(r.standard_normal(s)) for s in ((N, C, H, W), (E, 9, W), (E, 1, W), (C, E))]
    x, k, vec, we = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = [probes.grid_base(x), probes.grid_halo(x), probes.grid_const(x, k, vec),
           probes.grid_compute(x, we, k)]
    for name, g, want, tol in zip(("base", "halo", "const", "compute"), got, _np_grid(*arrays),
                                  (1e-5, 1e-5, 1e-5, 1e-3)):
        assert g.shape == (C, 1, 1) and g.dtype == torch.float32, name
        err = np.abs(g.numpy().ravel() - want).max() / np.abs(want).max()
        assert err <= tol, (name, err)
    # vec = -k[:, 0:1, :] cancels the bank: the x part alone is the base sum
    cancelled = probes.grid_const(x, k, -k[:, 0:1, :])
    base = _np_grid(*arrays)[0]
    assert np.abs(cancelled.numpy().ravel() - base).max() <= 1e-5 * np.abs(base).max()
    assert all(v == 0 for v in probes.launches.counts.values())  # no kernel on the CPU
    with pytest.raises(ValueError):
        probes.grid_base(x[:, :, :12])  # H % 8 != 0
    with pytest.raises(ValueError):
        probes.grid_compute(x, we[:, :2], k)  # E < C


def test_grid_compute_channel_sums_match_numpy_for_every_channel():
    """The compute chain's sums for all E expanded channels (what the kernel
    computes, so that no channel >= C can be skipped unseen) against numpy, and
    the probe's output as their first C."""
    N, C, E, H, W = 2, 4, 8, 32, 24
    r = np.random.default_rng(6)
    arrays = [_bf16(r.standard_normal(s)) for s in ((N, C, H, W), (E, 9, W), (E, 1, W), (C, E))]
    x, k, _, we = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    xd, kd, wd = (a.astype(np.float64) for a in (arrays[0], arrays[1], arrays[3]))
    z = _bf16(np.einsum("ce,nchw->nehw", wd, xd))
    s = _bf16(z.astype(np.float64) / (1 + np.exp(-z.astype(np.float64))))
    pad = np.pad(s, ((0, 0), (0, 0), (0, 0), (1, 1)))
    want = sum(_bf16(pad[..., b:b + W] * kd[None, :, 3 * a + b, None, :]).astype(np.float64)
               for a in range(3) for b in range(3)).sum((0, 2, 3))
    got = probes.plain_grid_compute_channel_sums(x, we, k)
    assert got.shape == (E,) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
    assert torch.equal(probes.grid_compute_channel_sums(x, we, k), got)
    assert torch.equal(probes.plain_grid_compute(x, we, k), got[:C].view(C, 1, 1))
    assert torch.equal(probes.grid_compute(x, we, k), got[:C].view(C, 1, 1))


@pytest.fixture(scope="module")
def jax_grid_sums():
    """The JAX script's base, halo and const Pallas kernels at the probe's inputs:
    ``probe_grid_overhead`` under interpret mode, its ``_timed`` (on the loaded
    module object only) replaced by one run of each kernel; the compute kernel is
    skipped (minutes of interpret mode on one core)."""
    jax_probe = _load_jax_probe()
    sums = {}

    def once(name, f, *args, **_):
        if not name.startswith("grid_compute"):
            sums[name.split("(")[0]] = np.asarray(jax.jit(f)(*args))

    jax_probe._timed = once
    with pltpu.force_tpu_interpret_mode():
        jax_probe.probe_grid_overhead()
    return sums


@pytest.fixture(scope="module")
def grid_inputs_cpu():
    return port_probe.grid_inputs("cpu")


@pytest.mark.parametrize("name", ["grid_base", "grid_halo", "grid_const"])
def test_grid_probes_match_the_jax_scripts_kernels(jax_grid_sums, grid_inputs_cpu, name):
    """Each port function against the JAX kernel's output, within 1e-5 of the
    largest entry. For const that entry is the bank term's, N H W * bank ~3e8 a
    channel, so the limit (~3e3) holds the bank term alone: the x part (~1e3 a
    channel) is below it. The x part is held to JAX through the base case, since
    ``plain_grid_const`` forms it by ``plain_grid_base``'s expression."""
    x, k, vec, _ = grid_inputs_cpu
    got = {"grid_base": lambda: probes.grid_base(x), "grid_halo": lambda: probes.grid_halo(x),
           "grid_const": lambda: probes.grid_const(x, k, vec)}[name]()
    want = jax_grid_sums[name]
    assert got.shape == want.shape == (x.shape[1], 1, 1) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("C,C2,H,W", [(16, 16, 8, 384), (16, 24, 8, 384), (5, 3, 8, 384),
                                      (16, 16, 8, 381)])
def test_channel_mix_matches_numpy_at_other_widths(C, C2, H, W):
    """The CPU path of ``channel_mix`` at the card tests' shapes (C2 != C, W % 4 != 0)."""
    r = np.random.default_rng(7)
    x, w = r.standard_normal((C, H, W)).astype(np.float32), r.standard_normal((C, C2)).astype(
        np.float32)
    got = probes.channel_mix(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (H, C2, W)
    np.testing.assert_allclose(got.numpy(), np.einsum("chw,cd->hdw", x, w), rtol=1e-5, atol=1e-5)


def test_const_kernel_call_sizes_its_scratch_from_the_slabs(monkeypatch):
    """``grid_const_kernel`` hands the launcher a scratch of min(N C H / 8, CONST_PARTS)
    rows of C + 1 floats (each block's channel partials and its bank share), its
    row count and E, on the tensor's device."""
    shapes, args = [], []
    new_empty = torch.Tensor.new_empty
    monkeypatch.setattr(torch.Tensor, "new_empty", lambda self, shape, dtype=None: (
        shapes.append(tuple(shape)), new_empty(self, shape, dtype=dtype))[1])
    monkeypatch.setattr(probes, "_grid_const", lambda *a: args.append(a))
    x = torch.zeros(2, 3, 16, 24, dtype=torch.bfloat16)
    k, vec = torch.zeros(5, 9, 24), torch.zeros(5, 1, 24)
    tall = torch.zeros(2, 3, 8 * 400, 2, dtype=torch.bfloat16)
    probes.grid_const_kernel(x, k, vec)
    probes.grid_const_kernel(tall, k[:, :, :2], vec[:, :, :2])
    parts = probes.CONST_PARTS
    assert shapes == [(12, 4), (3, 1, 1), (parts, 4), (3, 1, 1)]
    assert [a[0] for a in args] == [-1, -1] and [a[5] for a in args] == [12, parts]
    assert [a[7:] for a in args] == [(2, 3, 5, 16, 24), (2, 3, 5, 3200, 2)]


def test_grid_probe_script_times_each_kernel_on_the_cpu(monkeypatch, capsys):
    small = [torch.randn(2, 4, 16, 24), torch.randn(8, 9, 24), torch.randn(8, 1, 24),
             torch.randn(4, 8)]
    monkeypatch.setattr(port_probe, "grid_inputs",
                        lambda device: [t.bfloat16().to(device) for t in small])
    res = port_probe.main(["grid_overhead", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "PROBE grid_base(main only)", "PROBE grid_halo(min/max maps)",
        "PROBE grid_const(resident bank)", "PROBE grid_compute(z+silu+dw, no halo)"]
    assert set(res["grid_overhead"]) == {"base", "halo", "const", "compute"}
    assert all("us per block" in line for line in lines)


def test_launcher_binds_once_and_passes_the_device_and_its_stream(monkeypatch):
    """``cuda_lib.launcher``: nothing is built or bound until the first call;
    then the ctypes function is bound once and called with the arguments, the
    device index and that device's current raw stream; a CUDA error raises."""
    from mammo_clip_tpu_torch.ops import cuda_lib

    bound, calls, rcs = [], [], iter([0, 0, 700])

    class Lib:
        def __getattr__(self, name):
            bound.append(name)
            return lambda *args: (calls.append(args), next(rcs))[1]

    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "_raw_stream", None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 1000 + d, raising=False)
    launch = cuda_lib.launcher("pr_gram")
    assert bound == [] and launch.__name__ == "pr_gram"
    launch(3, 11, 12)
    launch(0, 21)
    assert bound == ["pr_gram"]
    assert calls == [(11, 12, 3, 1003), (21, 0, 1000)]
    with pytest.raises(RuntimeError, match="pr_gram launch failed with CUDA error 700"):
        launch(1)


def test_probe_launcher_signatures_match_the_c_interface():
    """Each ``pr_*`` function of csrc/probes.cu takes as many arguments as its
    ctypes signature declares; each launcher (all but the ``_info`` query) the
    device index and the stream last. pr_grid_compute takes the capacity of its
    partial sums after their pointer."""
    from mammo_clip_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC_DIR / "probes.cu").read_text()
    protos = dict(re.findall(r"^int (pr_\w+)\(([^)]*)\)", src, re.M))
    assert {"pr_grid_const", "pr_grid_const_info", "pr_empty"} <= set(protos)
    assert set(protos) == {k for k in cuda_lib.SIGNATURES if k.startswith("pr_")}
    for name, params in protos.items():
        params = [" ".join(p.split()) for p in params.split(",")]
        assert len(params) == len(cuda_lib.SIGNATURES[name]), name
        if not name.endswith("_info"):
            assert params[-2:] == ["int device", "void* stream"], name
    compute = [" ".join(p.split()) for p in protos["pr_grid_compute"].split(",")]
    assert compute[3:6] == ["float* part", "int parts", "float* out"]
    const = [" ".join(p.split()) for p in protos["pr_grid_const"].split(",")]
    assert const[3:6] == ["float* part", "int parts", "float* out"]
    assert const[6:-2] == ["int N", "int C", "int E", "int H", "int W"]
    grid_sum = [" ".join(p.split()) for p in protos["pr_grid_sum"].split(",")]
    assert grid_sum[:4] == ["int kind", "const void* x", "float* part", "float* out"]
    assert protos["pr_empty"].split(",")[0].strip() == "int device"


def test_wrappers_check_the_device_before_any_launch(monkeypatch):
    """CPU tensors take the plain versions without reaching a launcher; tensors
    on neither the CPU nor a card raise ValueError, as before."""
    def refuse(*args):
        raise AssertionError("a tensor that is not on a card reached a launcher")

    for name in ("_gram", "_copy_scale", "_channel_mix", "_grid_sum", "_grid_const",
                 "_grid_compute", "_empty"):
        monkeypatch.setattr(probes, name, refuse)
    before = dict(probes.launches.counts)
    x, w = torch.randn(4, 3, 8), torch.randn(4, 5)
    assert torch.equal(probes.gram_rows(x, 7), probes.plain_gram_rows(x, 7))
    assert torch.equal(probes.copy_scale(x, (4, 24), 2.0), probes.plain_copy_scale(x, (4, 24), 2.0))
    assert torch.equal(probes.channel_mix(x, w), probes.plain_channel_mix(x, w))
    xg = torch.randn(1, 2, 8, 4).bfloat16()
    kg, vg = torch.randn(3, 9, 4).bfloat16(), torch.randn(3, 1, 4).bfloat16()
    assert torch.equal(probes.grid_base(xg), probes.plain_grid_base(xg))
    assert torch.equal(probes.grid_const(xg, kg, vg), probes.plain_grid_const(xg, kg, vg))
    meta = torch.empty(4, 3, 8, device="meta")
    for call in (lambda: probes.gram_rows(meta), lambda: probes.copy_scale(meta, (4, 24)),
                 lambda: probes.channel_mix(meta, w.to("meta")),
                 lambda: probes.grid_base(xg.to("meta")),
                 lambda: probes.grid_const(xg.to("meta"), kg, vg)):
        with pytest.raises(ValueError):
            call()
    assert probes.launches.counts == before

"""Build and load the package's hand-written CUDA kernels.

The sources under ``mammo_clip_tpu_torch/csrc/*.cu`` have a plain ``extern "C"``
interface (no PyTorch headers), so one ``nvcc`` call builds them in seconds
into a shared library that ``ctypes`` loads; they share the device helpers of
``csrc/*.cuh``. The library lands at first use in
``mammo_clip_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash of
the sources, the headers and the flags, so a changed source or header is
rebuilt and an unchanged one is reused by later processes.

Nothing here runs at import: ``load()`` builds on its first call and raises if
``nvcc`` is missing or the build fails.

``launcher(name)`` is the lean way to call a launcher that takes the CUDA device
index and the stream as its last two arguments (``csrc/probes.cu``,
``csrc/flash_attention.cu`` and ``m6_pass`` of ``csrc/mbconv6_e6.cu``): it binds
the ctypes function once, on its first call, and then costs the host one
ctypes call and one lookup of PyTorch's current raw stream per launch, with no
``torch.cuda.Stream`` object and no device context (the C launcher switches
the device only when the tensor's is not the current one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# launcher name -> argument types (pointers and the stream as c_void_p)
SIGNATURES: Dict[str, List] = {
    # csrc/mbconv6_e6.cu: pass, 34 pointers, eps, the form, 9 shape ints and the
    # ranks, the device index, the stream
    "m6_pass": [_I, *[_P] * 34, _F, *[_I] * 11, _I, _P],
    "m6_scratch": [_I] * 10,
    "m6_kernel_info": [_I, _I, _I, _I, _P, _P],
    # csrc/flash_attention.cu: ..., the device index, the stream
    "fa_forward": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P],
    "fa_backward": [*[_P] * 6, _I, *[_P] * 4, _I, _I, _I, _F, _I, _P],
    # csrc/probes.cu: ..., the device index, the stream
    "pr_grid_sum": [_I, *[_P] * 3, *[_I] * 5, _P],
    "pr_grid_const": [*[_P] * 4, _I, _P, *[_I] * 6, _P],
    "pr_grid_const_info": [_P, _P],
    "pr_grid_compute": [*[_P] * 4, _I, _P, *[_I] * 6, _P],
    "pr_grid_compute_info": [_I, _P, _P],
    "pr_bf16_mul": [_P, _P, _P, _I, _I, _P],
    "pr_gram": [_P, _P, *[_I] * 5, _P],
    "pr_copy_scale": [_P, _P, _LL, _F, _I, _P],
    "pr_channel_mix": [_P, _P, _P, *[_I] * 5, _P],
    "pr_empty": [_I, _P],
}


class BuildInfo:
    """What the last ``build()`` of this process did."""

    path: Optional[Path] = None
    seconds: float = 0.0
    compiled: bool = False
    ptxas: str = ""


build_info = BuildInfo()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    """The sources nvcc compiles."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _inputs() -> List[Path]:
    """Everything the build reads: the sources and the headers they include."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1()
    for src in _inputs():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmammo_kernels-{h.hexdigest()[:12]}.so"


def build(ptxas_verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into one shared library (skipped when the
    library for these exact sources, headers and flags exists). With ``ptxas_verbose``
    the compiler's per-kernel register/shared-memory report is kept in
    ``build_info.ptxas``."""
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-8000:]}")
        os.replace(tmp, out)
        build_info.compiled = True
        build_info.ptxas = res.stderr
    build_info.path = out
    build_info.seconds = time.perf_counter() - t0
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare every launcher's argument types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


_raw_stream = None  # torch._C._cuda_getCurrentRawStream, looked up at the first bind


def _bind_launcher(name: str):
    global _raw_stream
    import torch

    # PyTorch's own Triton launcher reads the stream this way; CPU builds lack it.
    _raw_stream = torch._C._cuda_getCurrentRawStream
    return getattr(load(), name)


def launcher(name: str):
    """The C launcher ``name`` as ``launch(device, *args)``: it calls the launcher
    with ``args``, the CUDA device index and PyTorch's current raw stream on that
    device (so a caller's ``torch.cuda.stream(s)`` is obeyed), and raises if the
    launcher returns a CUDA error. The library is built and the function bound on
    the first call, not at import."""
    fn = None

    def launch(device: int, *args):
        nonlocal fn
        if fn is None:
            fn = _bind_launcher(name)
        rc = fn(*args, device, _raw_stream(device))
        if rc:
            raise RuntimeError(f"{name} launch failed with CUDA error {rc}")

    launch.__name__ = name
    return launch

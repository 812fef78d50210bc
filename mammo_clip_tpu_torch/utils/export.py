"""Serving export: the trained dual encoder as ``torch.export`` programs (port of
``mammo_clip_tpu/utils/export.py``).

The image- and text-embedding functions, in eval mode, are traced with the
trained parameters held in the program and saved as ``.pt2`` files. A serving
process loads and calls them without the model's code (``ServingModule``).

The contract of the calls is the JAX package's, and so is ``EmbeddingExtractor``'s:
  image_fn(images float32 (N, H, W, 1), already normalized) -> (N, D) unit-norm
  text_fn(input_ids int32 (N, S), attention_mask int32 (N, S)) -> (N, D)
Shapes are static per artifact: one artifact per serving batch shape.

Where the port's contract differs from JAX's:
- one ``.pt2`` per device (``image_fn.<device>.pt2``, ``text_fn.<device>.pt2``)
  in place of one StableHLO artifact lowered for several platforms: a
  ``torch.export`` program holds its device's tensors and operators;
- ``serving.json`` adds ``requires``: for each device, the modules a loader
  imports before it loads that device's programs, because their graphs call
  an operator of this package (``mammo_clip_tpu_torch.ops.flash_attention``
  for a ViT exported on a card: the hand flash kernel runs inside the
  artifact; empty on the CPU, where the plain version is traced);
- an fp32 artifact runs under full fp32: a fresh process lets cuDNN take TF32
  for fp32 convolutions by default, and the model was traced and checked with
  TF32 off (``utils/device.py::full_fp32``).

This module imports nothing of the package, so a serving process can load it
by its file path alone: ``ServingModule`` imports the ``requires`` modules and
nothing else of the package.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

# the package's custom operators an exported graph may call, and the module
# whose import registers each
OPERATOR_MODULES = {
    "mammo_clip_tpu_torch::flash_forward": "mammo_clip_tpu_torch.ops.flash_attention",
}
CONTRACT = ("normalized float32 NHWC images; int32 ids+mask; outputs are L2-normalized "
            "embeddings")


# each embedder's method and the CLIP's submodules it never reads
_EMBEDDERS = {"image_fn": ("embed_image", ("text_encoder", "text_projection")),
              "text_fn": ("embed_text", ("image_encoder", "image_projection"))}


class _Embedder(torch.nn.Module):
    """``model.<method>(*inputs, train=False)`` as a module to trace. It holds a
    shallow copy of ``model`` without the submodules in ``unused``: an exported
    program keeps every parameter of the module it traces, so the image program
    would otherwise carry BERT's weights and the text program the encoder's."""

    def __init__(self, model: torch.nn.Module, method: str, unused=()):
        super().__init__()
        part = copy.copy(model)
        part._modules = {k: v for k, v in model._modules.items() if k not in unused}
        self.model, self.method = part, method

    def forward(self, *inputs):
        return getattr(self.model, self.method)(*inputs, train=False)


def package_operators(program) -> set:
    """The names (``namespace::name``) of the package's operators a program calls."""
    names = set()
    for node in program.graph.nodes:
        target = node.target
        if node.op == "call_function" and isinstance(target, torch._ops.OpOverload):
            name = target.name().split(".")[0]
            if name in OPERATOR_MODULES:
                names.add(name)
    return names


def export_clip_serving(model: torch.nn.Module, image_hw: Tuple[int, int], text_len: int,
                        batch: int, out_dir: str,
                        devices: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Trace and save ``model.embed_image`` and ``model.embed_text`` (eval mode)
    for each of ``devices`` (default: the model's own), at (batch, H, W, 1) and
    (batch, text_len). Writes ``image_fn.<device>.pt2``, ``text_fn.<device>.pt2``
    and ``serving.json`` (shapes, embedding dim, devices as ``platforms``, the
    contract, ``requires``) to ``out_dir``; returns the file map."""
    h, w = image_hw
    home = next(model.parameters()).device
    devices = [torch.device(d) for d in (devices or [home])]
    was_training = model.training
    model.eval()
    os.makedirs(out_dir, exist_ok=True)
    files, requires, dim = {}, {}, None
    try:
        for dev in devices:
            same = dev.type == home.type and dev.index in (None, home.index)
            m = model if same else copy.deepcopy(model).to(dev)
            images = torch.zeros(batch, h, w, 1, device=dev)
            # two tensors: export would trace one example tensor passed twice as one input
            ids, mask = (torch.ones(batch, text_len, dtype=torch.int32, device=dev)
                         for _ in range(2))
            inputs = {"image_fn": (images,), "text_fn": (ids, mask)}
            programs = {name: torch.export.export(_Embedder(m, method, unused), inputs[name])
                        for name, (method, unused) in _EMBEDDERS.items()}
            ops = set()
            for name, program in programs.items():
                path = os.path.join(out_dir, f"{name}.{dev.type}.pt2")
                torch.export.save(program, path)
                files[f"{name}.{dev.type}"] = path
                ops |= package_operators(program)
            requires[dev.type] = sorted({OPERATOR_MODULES[op] for op in ops})
            out = programs["image_fn"].graph_module.graph.output_node().args[0][0]
            dim = int(out.meta["val"].shape[-1])
            del m, programs
    finally:
        model.train(was_training)
    manifest = {
        "image_input": [batch, h, w, 1],
        "text_input": [batch, text_len],
        "embedding_dim": dim,
        "platforms": [d.type for d in devices],
        "contract": CONTRACT,
        "requires": requires,
    }
    path = os.path.join(out_dir, "serving.json")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    files["manifest"] = path
    return files


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for the span, the flags restored after (``utils/device.py::full_fp32``,
    copied: this module imports nothing of the package)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class ServingModule:
    """Loaded serving artifact: callable embedders, no model code needed.

    ``device`` picks the programs (``cpu`` or ``cuda``); it may be left out when
    the artifact holds one device's. The modules ``serving.json`` lists under
    ``requires`` for that device are imported first; nothing else of the package
    is. Inputs are moved to the device; the calls run under
    ``torch.inference_mode()`` with TF32 off."""

    def __init__(self, out_dir: str, device: Optional[str] = None):
        with open(os.path.join(out_dir, "serving.json")) as f:
            self.manifest = json.load(f)
        platforms = self.manifest["platforms"]
        if device is None:
            if len(platforms) != 1:
                raise ValueError(f"the artifact holds programs for {platforms}: name a device")
            device = platforms[0]
        self.device = torch.device(device)
        if self.device.type not in platforms:
            raise ValueError(f"the artifact holds programs for {platforms}, not {device}")
        for module in self.manifest["requires"].get(self.device.type, []):
            importlib.import_module(module)
        load = lambda name: torch.export.load(
            os.path.join(out_dir, f"{name}.{self.device.type}.pt2")).module()
        self._image, self._text = load("image_fn"), load("text_fn")

    def embed_images(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), _full_fp32():
            return self._image(images.to(self.device))

    def embed_texts(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), _full_fp32():
            return self._text(input_ids.to(self.device, torch.int32),
                              attention_mask.to(self.device, torch.int32))

"""The benchmark's tests: on the CPU at tiny sizes, and (marked ``cuda``) on a
card, where they skip themselves when none is present.

    python3 -m pytest portbench/tests -q            # here
    python3 -m pytest portbench/tests -q -m cuda    # on a card
"""

import copy
import json
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; the test skips itself when none is present")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


TINY_TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                 max_position_embeddings=64)


def tiny_config(name: str) -> dict:
    """A configuration file of the benchmark shrunk to CPU-test sizes: B0 or a
    two-layer ViT at 64x48, a two-layer BERT of width 32, 16 tokens."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = cfg["config"]
    e = c["model"]["image_encoder"]
    if e["name"].startswith("vit"):
        e.update(patch_size=8, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64, base_grid=4)
    else:
        e["name"] = "efficientnet-b0"
    c["model"]["text_encoder"].update(TINY_TEXT)
    c["model"]["projection_head"]["proj_dim"] = 16
    c["data"].update(image_size_h=64, image_size_w=48, text_max_length=16)
    return cfg


def tiny_traffic(name: str) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t["texts"]["length_min"] = 4
    if t["loop"] == "pretrain":
        t["images"]["rows"] = t["texts"]["rows"] = 4
        t["profile_steps"] = 1
    else:
        t["images"]["rows"] = t["extractor_batch"] = 8
        t["texts"]["rows"] = 2
    return t


@pytest.fixture
def tiny_cell():
    """tiny_cell(workload) -> a ``Cell`` of that workload at CPU-test sizes,
    held to the workload's own limits."""
    from portbench.harness import manifest

    def make(workload: str):
        real = manifest.resolve(workload)
        return manifest.Cell(real.name, 1, real.config_name, tiny_config(real.config_name),
                             real.traffic_name, tiny_traffic(real.traffic_name),
                             real.end_to_end, real.per_layer, copy.deepcopy(real.limits), BENCH)

    return make

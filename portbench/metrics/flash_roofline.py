"""flash_roofline: the flash-attention kernels' share of their roofline, in %.

Over the profiled steps: the sum of every flash call's bound
(``reference/flops.py::flash_bound_s``: the forward's 2 and the backward's 4
products of the function, not the kernel's recompute) over the device time
of the kernels of ``csrc/flash_attention.cu``. Every layer of every tower
pass makes one forward and one backward call on (rows, heads, tokens,
head_dim). Nothing when the profile holds none of them.
"""

import re

from portbench.reference import flops

NAMES = "fwd_tc|dkdv_tc|dq_tc|dot_v8|fwd|dkdv|dq|dot"
KERNEL = re.compile(rf"(?<!::)\(anonymous namespace\)::(?:{NAMES})_kernel\b"
                    rf"|_GLOBAL__N_1\d+(?:{NAMES})_kernel")


def read(run):
    if run.profile is None:
        return None
    device_s = run.profile.kernel_s(lambda name: bool(KERNEL.search(name)))
    if device_s <= 0.0:
        return None
    cfg, images = run.config["config"], run.traffic["images"]
    v, data = cfg["model"]["image_encoder"], cfg["data"]
    tokens = (data["image_size_h"] // v["patch_size"]) * (data["image_size_w"] // v["patch_size"]) + 1
    heads, head_dim = v["num_heads"], v["hidden_size"] // v["num_heads"]
    calls = len(images["keys"]) * v["num_layers"]
    bound = calls * sum(flops.flash_bound_s(images["rows"], heads, tokens, head_dim, bwd)
                        for bwd in (False, True))
    return 100.0 * bound * run.profile.calls / device_s

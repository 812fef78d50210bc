"""mbconv_roofline: the fused MBConv kernels' share of their roofline, in %.

Over the profiled steps: the sum of every fused call's bound (the least time
of its function on the card, ``reference/flops.py::mbconv_bound_s`` at the
call's valid N x vh x vw, forward and backward of each fused block of each
tower pass) over the device time of the kernels of ``csrc/mbconv6_e6.cu``.
Nothing when the profile holds none of them.
"""

import re

from portbench.reference import flops
from portbench.reference.efficientnet import variant_of

NAMES = "sweep|bwd_v|bwd_x|moments|out|dx_pad|dx|prep1|prep|bn0_bwd|bn0|sum_blocks"
KERNEL = re.compile(rf"(?<!::)\(anonymous namespace\)::(?:{NAMES})_kernel\b"
                    rf"|_GLOBAL__N_1\d+(?:{NAMES})_kernel")


def read(run):
    if run.profile is None:
        return None
    device_s = run.profile.kernel_s(lambda name: bool(KERNEL.search(name)))
    if device_s <= 0.0:
        return None
    cfg, images = run.config["config"], run.traffic["images"]
    data = cfg["data"]
    bound = flops.mbconv_step_bound_s(variant_of(cfg["model"]["image_encoder"]["name"]),
                                      images["rows"], data["image_size_h"],
                                      data["image_size_w"], len(images["keys"]))
    return 100.0 * bound * run.profile.calls / device_s

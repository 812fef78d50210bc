"""mfu.train: the whole training step's share of the card's peak, in %: the
model FLOPs of the profiled steps (``reference/flops.py::train_step_flops``:
3x the forward's convolutions and products, no recompute, no padding) over
the profiled span, over the peak of the step's product type (bf16)."""

from portbench.reference import flops


def read(run):
    if run.profile is None or run.profile.span_s() <= 0.0:
        return None
    cfg, traffic = run.config["config"], run.traffic
    data = cfg["data"]
    images = len(traffic["images"]["keys"]) * traffic["images"]["rows"]
    texts = len(traffic["texts"]["keys"]) * traffic["texts"]["rows"]
    step = flops.train_step_flops(cfg["model"], data["image_size_h"], data["image_size_w"],
                                  data["text_max_length"], images, texts)
    return 100.0 * step * run.profile.calls / run.profile.span_s() / flops.PEAK[run.peak]

"""mfu.embed: the extractor's share of the card's peak, in %: the model FLOPs
of the profiled batches (``reference/flops.py::clip_forward_flops`` of each
batch's views and reports, forward only; the rows the extractor pads a
partial batch with are not counted) over the profiled span, over the peak
of the products' type (fp32 activations, whose convolutions cuDNN runs in
TF32 by default)."""

from portbench.reference import flops


def read(run):
    if run.profile is None or run.profile.span_s() <= 0.0:
        return None
    cfg, traffic = run.config["config"], run.traffic
    data = cfg["data"]
    images = len(traffic["images"]["keys"]) * traffic["images"]["rows"]
    texts = len(traffic["texts"]["keys"]) * traffic["texts"]["rows"]
    batch = flops.clip_forward_flops(cfg["model"], data["image_size_h"], data["image_size_w"],
                                     data["text_max_length"], images, texts)
    return 100.0 * batch * run.profile.calls / run.profile.span_s() / flops.PEAK[run.peak]

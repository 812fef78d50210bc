"""device_idle_share.embed: the share of the profiled span, in %, in which no
operation ran on the device: 1 - (the union of the device operations'
intervals) / (first start to last end), over the window's profiled batches."""


def read(run):
    if run.profile is None or run.profile.span_s() <= 0.0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.span_s())

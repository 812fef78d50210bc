"""mbconv_calls.b5: calls of the fused MBConv kernel path a step, forward and
backward (``ops/mbconv.py::launches``), over the window's instrumented steps."""


def read(run):
    return run.counters.get("mbconv_calls")

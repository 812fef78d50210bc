"""flash_calls.vit: calls of the flash-attention kernel path a step, forward
and backward (``ops/flash_attention.py::launches``), over the window's
instrumented steps."""


def read(run):
    return run.counters.get("flash_calls")

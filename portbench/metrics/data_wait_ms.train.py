"""data_wait_ms.train: mean host ms a step spent in ``next()`` of the prefetch
iterator (``data/pipeline.py``) over the window's instrumented steps."""


def read(run):
    spans = run.spans.get("data_wait")
    return 1e3 * sum(spans) / len(spans) if spans else None

"""embed_batch_ms_p90.embed: the 90th percentile of the host ms a batch of
the extractor (``eval/embeddings.py``: the views' and the reports' calls,
each ending in a copy to the host) took in the window."""

import statistics


def read(run):
    spans = run.spans.get("batch", [])
    if len(spans) < 2:
        return None
    return 1e3 * statistics.quantiles(spans, n=10)[-1]

"""dispatch_ms.train: mean host ms from the call of the train step
(``train/step.py``) to its return, unsynchronised: the host's dispatch time a
step. When it nears ``step_ms_p90.train``, the host sets the pace."""


def read(run):
    spans = run.spans.get("dispatch")
    return 1e3 * sum(spans) / len(spans) if spans else None

"""step_ms_p90.train: the 90th percentile of the device-timeline ms between
consecutive steps' ends (CUDA events recorded after each step's call)."""

import statistics


def read(run):
    if len(run.step_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.step_s, n=10)[-1]

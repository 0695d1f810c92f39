"""call_ms_p95: the 95th percentile (nearest rank) over every call of the
window of the time from issuing the call to its mean return on the host,
in milliseconds."""

from benchmark.measure import percentile


def read(record):
    calls = record["calls"]
    if not calls:
        return None
    return 1e3 * percentile([t2 - t0 for t0, _, t2 in calls], 0.95)

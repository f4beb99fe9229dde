"""Front end (``serving/query_server.py`` and the engine's admission
queues): the 95th percentile, over the untraced window's interactions,
of the time from an interaction's due time to the start of the
``dispatch()`` that carried its last query; one never dispatched counts
as failed."""
from bench import stats


def read(rec):
    waits = rec["admit_wait_ms"]
    return stats.pctl(waits, 95) if waits else None

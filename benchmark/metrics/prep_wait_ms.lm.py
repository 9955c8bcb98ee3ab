"""The task loop's waits for host ingest (PhaseTimers prep_wait) in the window, ms per training task."""

import readers


def read(w):
    return readers.phase_ms_per_task(w, "prep_wait")

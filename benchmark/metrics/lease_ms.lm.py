"""The task loop's lease RPCs (PhaseTimers lease_wait) in the window, ms per training task."""

import readers


def read(w):
    return readers.phase_ms_per_task(w, "lease_wait")

"""The task loop's upload and scan dispatch (PhaseTimers dispatch) in the window, ms per training task."""

import readers


def read(w):
    return readers.phase_ms_per_task(w, "dispatch")

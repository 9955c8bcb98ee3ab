"""The device's wait between two training tasks on its own clock (the
program's ``device_gap``: the previous task's fetch event to this task's
start event), ms per training task completed in the window. Nothing where
the program records no such time."""

import readers


def read(w):
    if "device_gap" not in w.phases1:
        return None
    return readers.phase_ms_per_task(w, "device_gap")

"""A training task's time on the device's own clock (the program's
``device_task``: its start event to its metrics fetch's event), ms per
training task completed in the window. Nothing where the program records
no such time."""

import readers


def read(w):
    if "device_task" not in w.phases1:
        return None
    return readers.phase_ms_per_task(w, "device_task")

"""The 90th percentile of a training task's wall, lease to report, in ms."""

import readers


def read(w):
    return readers.task_ms(w, 90)

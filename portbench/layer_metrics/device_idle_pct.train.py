"""``device_idle_pct.train``: ``readers.device_idle_pct`` of the train cells."""

from portbench import readers


def read(run):
    return readers.device_idle_pct(run, "train")

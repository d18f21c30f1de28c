"""``device_idle_pct.reg``: ``readers.device_idle_pct`` of the reg cells."""

from portbench import readers


def read(run):
    return readers.device_idle_pct(run, "reg")

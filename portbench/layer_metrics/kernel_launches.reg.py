"""``kernel_launches.reg``: ``counters.kernel_launches`` of the reg cells."""

from portbench import counters


def read(run):
    return counters.kernel_launches(run, "reg")

"""``kernel_launches.train``: ``counters.kernel_launches`` of the train cells."""

from portbench import counters


def read(run):
    return counters.kernel_launches(run, "train")

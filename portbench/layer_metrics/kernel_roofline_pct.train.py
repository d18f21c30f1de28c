"""``kernel_roofline_pct.train``: ``readers.kernel_roofline_pct`` of the train cells."""

from portbench import readers


def read(run):
    return readers.kernel_roofline_pct(run, "train")

"""``kernel_roofline_pct.reg``: ``readers.kernel_roofline_pct`` of the reg cells."""

from portbench import readers


def read(run):
    return readers.kernel_roofline_pct(run, "reg")

"""``peak_mem_gib.reg``: ``readers.peak_mem_gib`` of the reg cells."""

from portbench import readers


def read(run):
    return readers.peak_mem_gib(run, "reg")

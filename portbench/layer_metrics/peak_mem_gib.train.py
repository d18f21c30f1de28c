"""``peak_mem_gib.train``: ``readers.peak_mem_gib`` of the train cells."""

from portbench import readers


def read(run):
    return readers.peak_mem_gib(run, "train")

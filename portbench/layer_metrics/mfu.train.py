"""``mfu.train``: ``readers.mfu`` of the train cells."""

from portbench import readers


def read(run):
    return readers.mfu(run, "train")

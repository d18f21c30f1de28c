"""``mfu.reg``: ``readers.mfu`` of the reg cells."""

from portbench import readers


def read(run):
    return readers.mfu(run, "reg")

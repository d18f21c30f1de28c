"""``conv_ms.reg``: ``readers.conv_ms`` of the reg cells."""

from portbench import readers


def read(run):
    return readers.conv_ms(run, "reg")

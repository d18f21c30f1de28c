"""``conv_ms.train``: ``readers.conv_ms`` of the train cells."""

from portbench import readers


def read(run):
    return readers.conv_ms(run, "train")

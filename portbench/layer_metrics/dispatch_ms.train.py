"""``dispatch_ms.train``: ``readers.dispatch_ms`` of the train cells."""

from portbench import readers


def read(run):
    return readers.dispatch_ms(run, "train")

"""``dispatch_ms.reg``: ``readers.dispatch_ms`` of the reg cells."""

from portbench import readers


def read(run):
    return readers.dispatch_ms(run, "reg")

"""``setup_s``: from run.py's first statement to the first timed step."""


def read(run):
    return run.setup_s

"""``train_pairs_per_s``: every pair the window's train steps consumed over
the whole window, which ends in a synchronise."""


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    return run.pairs / run.window_s

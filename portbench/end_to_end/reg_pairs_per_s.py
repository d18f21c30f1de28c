"""``reg_pairs_per_s``: the pairs of every request completed in the window
over the whole window."""


def read(run):
    if run.kind != "reg" or not run.window_s:
        return None
    return run.pairs / run.window_s

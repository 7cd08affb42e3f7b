"""``build_trees_per_s``: PLaNT trees committed in the window over the
window's wall time (host clock, from its start to the end of its last
batch, with the device synchronised)."""


def read(run):
    if not run.trees or run.window_s <= 0:
        return None
    return run.trees / run.window_s

"""Share of the traced window in which no kernel, copy or fill runs on the
card (rank 0's card in a sharded cell)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)

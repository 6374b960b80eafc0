"""Share of the traced window with no kernel, copy or set on the card."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)

"""Every output token the engine served in the window, over the window's
seconds; tokens of requests still unfinished at its end count too."""


def read(run):
    n = sum(1 for r in run.recs for t in r.tokens if run.in_window(t))
    return n / run.window_s

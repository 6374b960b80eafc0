"""The traced window's host seconds over the engine's macro-cycles in it."""


def read(run):
    cycles = run.counters1["cycles"] - run.counters0["cycles"]
    return 1e3 * run.window_s / cycles if cycles else None

"""Pool traversals a steady decode step took in the window (a step carrying
both an append and a read): claim C1, one traversal for both ports."""


def read(run):
    steps = run.counters1["steady_steps"] - run.counters0["steady_steps"]
    trav = (run.counters1["steady_traversals"]
            - run.counters0["steady_traversals"])
    return trav / steps if steps else None

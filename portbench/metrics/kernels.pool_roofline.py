"""B3's share of its roofline in the window: the least time each pool
traversal needs for the words its ports write and read
(``arith.pool_work``, at bf16) over B3's device time."""
from portbench import arith, tracing


def read(run):
    if run.trace is None or not run.pool_lanes:
        return None
    measured = tracing.kernel_s(run.trace, "B3")
    if measured <= 0:
        return None
    need = sum(arith.bound_s(arith.pool_work(w, r, run.word_width), 0.0)
               for w, r in run.pool_lanes)
    return 100.0 * need / measured

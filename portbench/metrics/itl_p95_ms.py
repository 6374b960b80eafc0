"""95th percentile of every gap between consecutive output tokens of
every request, both tokens served in the window; each gap is one sample."""
from portbench.arith import percentile


def read(run):
    gaps = run.itl_gaps()
    return 1e3 * percentile(gaps, 95) if gaps else None

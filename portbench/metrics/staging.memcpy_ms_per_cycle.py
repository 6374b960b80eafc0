"""Device milliseconds of host-to-device and device-to-host copies in the
traced window, per engine macro-cycle."""
from portbench import tracing


def read(run):
    cycles = run.counters1["cycles"] - run.counters0["cycles"]
    if run.trace is None or not cycles:
        return None
    return 1e3 * tracing.memcpy_s(run.trace) / cycles

"""Device milliseconds of the kernels launched under the benchmark's span
around the model's decode step, per call."""
from portbench import tracing


def read(run):
    if run.trace is None:
        return None
    calls = run.trace["span_calls"].get(tracing.DECODE, 0)
    if not calls:
        return None
    return 1e3 * run.trace["span_device_s"][tracing.DECODE] / calls

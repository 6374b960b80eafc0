"""Decode attention's share of its roofline in the window: the least time
the decode attention of every dispatched step needs
(``arith.decode_attention_work`` per layer over the live rows' lengths, at
bf16) over the device time of every kernel that serves it: B1 in one
launch, or B4a and B4b when the program splits the keys."""
from portbench import arith, tracing


def read(run):
    if run.trace is None or not run.decode_lens:
        return None
    measured = tracing.kernel_s(run.trace, "B1", "B4a", "B4b")
    if measured <= 0:
        return None
    cfg = run.cfg
    need = 0.0
    for lens in run.decode_lens:
        nbytes, flops = arith.decode_attention_work(
            lens, cfg["num_attention_heads"], cfg["num_key_value_heads"],
            arith.head_dim(cfg))
        need += cfg["num_hidden_layers"] * arith.bound_s(nbytes, flops)
    return 100.0 * need / measured

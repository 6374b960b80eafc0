"""The whole serving step's share of the bf16 peak: model operations of
every token processed in the traced window (prompt chunks and decoded
tokens: 2 x active parameters, plus attention over each token's live
context) over the window's seconds x 989 TFLOP/s."""
from portbench import arith


def read(run):
    if run.trace is None:
        return None
    cfg = run.cfg
    flops = sum(arith.sequence_flops(cfg, o, n) for o, n in run.prefill_rows)
    flops += sum(arith.token_flops(cfg, n) for lens in run.decode_lens
                 for n in lens)
    return 100.0 * flops / (run.window_s * arith.H100_BF16_FLOPS)

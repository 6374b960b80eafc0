"""The metrics' arithmetic: percentiles and rates over every sample, a
stall inside the window moving the tail, and the roofline counts."""
import statistics

import pytest

from portbench import arith
from portbench import harness
from portbench.serve import Rec, Run


class _Req:
    def __init__(self, done=False):
        self.done, self.shed_reason = done, None


def _run(token_times: list) -> Run:
    run = Run({}, {}, {"loop": "closed"})
    run.t0, run.t_end = 0.0, 10.0
    for ts in token_times:
        run.recs.append(Rec(_Req(), 0.0, tokens=list(ts)))
    return run


def test_percentile_matches_numpy_linear():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0, 10.0]
    assert arith.percentile(xs, 50) == 3.5
    assert arith.percentile(xs, 95) == pytest.approx(8.75)
    assert arith.percentile([7.0], 95) == 7.0
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert arith.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_rate_counts_every_token_in_the_window():
    run = _run([[0.5 * k for k in range(1, 21)], [9.9, 10.5]])
    read = harness.reader("output_tokens_per_s")
    assert read(run) == pytest.approx(21 / 10.0)     # 20 + 9.9; 10.5 is out


def test_a_stall_in_the_window_moves_the_itl_tail():
    steady = [[0.1 * k for k in range(1, 99)] for _ in range(4)]
    read = harness.reader("itl_p95_ms")
    base = read(_run(steady))
    assert base == pytest.approx(100.0)
    stalled = [list(ts) for ts in steady]
    for ts in stalled:                       # every request waits 1.5 s once
        for j in range(50, len(ts)):
            ts[j] += 1.5
    ts_all = [t for ts in stalled for t in ts]
    assert max(ts_all) < 11.5
    run = _run(stalled)
    run.t_end = 11.5
    assert read(run) == pytest.approx(100.0)   # 4 stalls in ~390 gaps: p95 holds
    many = [list(ts) for ts in steady]
    for ts in many:                          # a stall every 10 tokens
        for j in range(len(ts)):
            ts[j] += 0.5 * (j // 10)
    run = _run(many)
    run.t_end = 20.0
    assert read(run) == pytest.approx(600.0)   # the tail is the stalled gap


def test_decode_attention_work_known_shape():
    # one row of 1000 cached tokens, 16 heads over 2 KV heads of 128
    nbytes, flops = arith.decode_attention_work([1000], 16, 2, 128)
    assert nbytes == (2 * 16 * 128 + 2 * 1000 * 2 * 128 + 2 * 2 * 128) * 2
    assert flops == 4.0 * 16 * 128 * 1001
    assert arith.bound_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)


def test_pool_work_and_token_flops():
    assert arith.pool_work(3, 5, 100) == 2 * 8 * 100 * 2
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "intermediate_size": 16,
           "num_hidden_layers": 3, "vocab_size": 10}
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    assert arith.active_params(cfg) == 3 * (attn + 3 * 8 * 16) + 80
    t = [arith.token_flops(cfg, c) for c in range(5, 9)]
    assert arith.sequence_flops(cfg, 5, 4) == pytest.approx(sum(t))

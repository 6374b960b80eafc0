"""The benchmark's frozen arithmetic: percentiles and spreads, the bounded
Pareto lengths of the traffic, the H100's published peaks, and the work
(bytes and operations) that each measured kernel and a whole serving step
need. Nothing here imports the program: what a layer must move or compute
is counted from the configuration and the live lengths, never from how the
program stages its data, so a later change to the staging is measured
against the same work.
"""
from __future__ import annotations

import math
import statistics
from typing import Sequence

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
H100_BYTES_PER_S = 3.35e12          # HBM3
H100_BF16_FLOPS = 989e12            # bf16 tensor cores
BF16_BYTES = 2                      # the configurations' compute dtype


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, by linear interpolation
    between closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(n=4)``, the rule the bounds follow)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def bounded_pareto(u: float, alpha: float, lo: float, hi: float) -> float:
    """The bounded Pareto(alpha) on [lo, hi] at quantile ``u`` in [0, 1):
    most mass near ``lo``, a heavy tail toward ``hi``, never past it."""
    ratio = (lo / hi) ** alpha
    return lo / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the bf16 tensor-core peak."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS)


def decode_attention_work(lens: Sequence[int], n_heads: int, n_kv_heads: int,
                          head_dim: int) -> tuple[float, float]:
    """(bytes, operations) one decode attention call needs over its live
    rows, ``lens`` being each live row's cached length before the append:
    q read and the output written, every cached K and V row read once, the
    appended k and v written once, in bf16; QK and PV over len + 1 keys."""
    nbytes = flops = 0.0
    for n in lens:
        keys = n + 1
        nbytes += (2 * n_heads * head_dim            # q in, out back
                   + 2 * n * n_kv_heads * head_dim    # cached K, V
                   + 2 * n_kv_heads * head_dim        # appended k, v
                   ) * BF16_BYTES
        flops += 4.0 * n_heads * head_dim * keys
    return nbytes, flops


def pool_work(write_words: int, read_words: int, word_width: int) -> float:
    """Bytes a pool traversal's ports need: each written word read from
    its payload and written to the pool, each read word read from the pool
    and written to its output, in bf16."""
    return 2.0 * (write_words + read_words) * word_width * BF16_BYTES


def active_params(cfg: dict) -> float:
    """Parameters each token multiplies through, from a dense decoder's
    configuration file (a tied head counted once as the head; the
    embedding is a lookup)."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    ffn = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def token_flops(cfg: dict, context: int) -> float:
    """Model operations of one token at ``context`` tokens before it: the
    matmuls of its active parameters, and QK and PV over its keys."""
    attn = (4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * head_dim(cfg) * (context + 1))
    return 2.0 * active_params(cfg) + attn


def sequence_flops(cfg: dict, start: int, n: int) -> float:
    """Model operations of the ``n`` tokens at positions [start, start + n):
    ``token_flops`` summed in closed form."""
    per_key = (4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
               * head_dim(cfg))
    keys = n * (start + 1) + n * (n - 1) / 2.0
    return 2.0 * active_params(cfg) * n + per_key * keys

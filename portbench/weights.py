"""Random weights of a configuration, made on the device from the seed.

Every leaf is drawn in the dtype it is served in, one call per layer of a
stacked leaf, each call from its own generator keyed by (seed, leaf,
layer). So the same seed gives the same bits, and any one layer of any
leaf can be drawn again alone: the reference draws each layer again when
it needs it and never reads what the program was handed.

The layout is the one the serving program takes (a nested dict; block
leaves stacked on a leading layer axis). Scales: the embedding at the
configuration's ``initializer_range`` (a tied head is the embedding
transposed, so its logits are of order 1), linear weights N(0, 1/fan_in),
norm scales 1 + N(0, 0.1^2) and QKV
biases N(0, 0.1^2), so that the norms' and biases' weights are exercised.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["torch_dtype"])


def leaves(cfg: dict) -> list:
    """(path, per-layer shape, kind, scale, stacked) of every leaf."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    init = cfg["initializer_range"]
    out = [(("embed", "w"), (v, d), "normal", init, False),
           (("final_norm", "scale"), (d,), "norm", 0.1, False)]
    if not cfg["tie_word_embeddings"]:
        out.append((("lm_head", "w"), (d, v), "normal", 1 / math.sqrt(d),
                    False))
    lay = [(("ln1", "scale"), (d,), "norm", 0.1),
           (("ln2", "scale"), (d,), "norm", 0.1)]
    for name, width in (("wq", h * hd), ("wk", hkv * hd), ("wv", hkv * hd)):
        lay.append((("attn", name, "w"), (d, width), "normal",
                    1 / math.sqrt(d)))
        if cfg["qkv_bias"]:
            lay.append((("attn", name, "b"), (width,), "normal", 0.1))
    lay.append((("attn", "wo", "w"), (h * hd, d), "normal",
                1 / math.sqrt(h * hd)))
    f = cfg["intermediate_size"]
    lay += [(("ffn", "w_gate", "w"), (d, f), "normal", 1 / math.sqrt(d)),
            (("ffn", "w_up", "w"), (d, f), "normal", 1 / math.sqrt(d)),
            (("ffn", "w_down", "w"), (f, d), "normal", 1 / math.sqrt(f))]
    out += [(("layers",) + p, s, k, sc, True) for p, s, k, sc in lay]
    return out


def _generator(seed: int, leaf: int, layer: int, device) -> torch.Generator:
    key = np.random.SeedSequence([seed, leaf, layer]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key) & (2**63 - 1))


def draw(cfg: dict, seed: int, leaf: int, layer: int, device,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """Layer ``layer`` of leaf number ``leaf`` (0 for an unstacked leaf), in
    the served dtype; written into ``out`` when given."""
    _, shape, kind, scale, _ = leaves(cfg)[leaf]
    gen = _generator(seed, leaf, layer, device)
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype_of(cfg))
    x.mul_(scale)
    if kind == "norm":
        x.add_(1.0)
    if out is not None:
        out.copy_(x)
        return out
    return x


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(cfg: dict, seed: int, device) -> dict:
    """Every weight of the configuration, in the serving program's layout."""
    n = cfg["num_hidden_layers"]
    params: dict = {}
    for i, (path, shape, _, _, stacked) in enumerate(leaves(cfg)):
        if stacked:
            t = torch.empty((n, *shape), dtype=dtype_of(cfg), device=device)
            for layer in range(n):
                draw(cfg, seed, i, layer, device, out=t[layer])
        else:
            t = draw(cfg, seed, i, 0, device)
        _put(params, path, t)
    if cfg["tie_word_embeddings"]:
        params["lm_head"] = {"w": params["embed"]["w"].t()}
    return params


def layer_f32(cfg: dict, seed: int, layer: int, device) -> dict:
    """One layer's block weights drawn again, in float32, keyed as in the
    layout under ``layers``."""
    out: dict = {}
    for i, (path, _, _, _, stacked) in enumerate(leaves(cfg)):
        if stacked:
            _put(out, path[1:], draw(cfg, seed, i, layer, device).float())
    return out


def top_f32(cfg: dict, seed: int, device) -> dict:
    """The embedding, the final norm and the head drawn again in float32."""
    out: dict = {}
    for i, (path, _, _, _, stacked) in enumerate(leaves(cfg)):
        if not stacked:
            _put(out, path, draw(cfg, seed, i, 0, device).float())
    if cfg["tie_word_embeddings"]:
        out["lm_head"] = {"w": out["embed"]["w"].t()}
    return out

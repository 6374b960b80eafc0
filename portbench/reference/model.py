"""The plain reference of the served dense decoders, in float32 PyTorch.

It follows the published equations (Qwen2: RMSNorm, rotary embeddings on
the halves of each head, causal grouped-query attention with QKV bias,
SwiGLU) with no kernel, no cache and no batching, and imports nothing of
the program.

It runs layer by layer over all the sequences it is given, drawing each
layer's weights again from the seed (``portbench.weights``) in float32,
so that the weights of one layer at a time are held. TF32 is off.

``precision="fp8"`` is the control: every weight matrix rounded to
float8 e4m3 with a scale per output column before its product, the
step below the configurations' bfloat16.
"""
from __future__ import annotations

import contextlib

import torch

from portbench import weights as W

FP8_MAX = 448.0                    # largest finite float8 e4m3fn value


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _rounded(w: torch.Tensor, precision: str) -> torch.Tensor:
    """``w`` [..., d_in, d_out] as the given precision holds it."""
    if precision == "float32":
        return w
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x [T, H, D] at positions 0..T-1, the halves of each head rotated."""
    t, _, d = x.shape
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, q_block: int = 512):
    """Causal grouped-query attention of one sequence: q [T, H, D],
    k, v [T, Hkv, D] -> [T, H, D]."""
    t, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # [H, T, D]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(t, device=q.device)
    for c0 in range(0, t, q_block):
        qc = q[c0:c0 + q_block].transpose(0, 1)              # [H, C, D]
        sc = qc @ k.transpose(1, 2) / d ** 0.5                # [H, C, T]
        qpos = torch.arange(c0, c0 + qc.shape[1], device=q.device)
        sc = sc.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
        out[c0:c0 + q_block] = (torch.softmax(sc, -1) @ v).transpose(0, 1)
    return out


def _swiglu(x, wg, wu, wd):
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


def logits(cfg: dict, seed: int, seqs: list, positions: list, device, *,
           precision: str = "float32") -> list:
    """Logits [len(positions[i]), V] of each sequence ``seqs[i]`` (token ids)
    at the positions asked for, each sequence read causally from its
    start."""
    with _no_tf32(), torch.no_grad():
        return _logits(cfg, seed, seqs, positions, device, precision)


def _logits(cfg, seed, seqs, positions, device, precision):
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    top = W.top_f32(cfg, seed, device)
    ids = [torch.tensor(s, dtype=torch.long, device=device) for s in seqs]
    xs = [top["embed"]["w"][i] for i in ids]
    del top
    for layer in range(cfg["num_hidden_layers"]):
        p = W.layer_f32(cfg, seed, layer, device)
        att = p["attn"]
        for j, x in enumerate(xs):
            y = _rmsnorm(x, p["ln1"]["scale"], eps)
            qkv = []
            for name, heads in (("wq", h), ("wk", hkv), ("wv", hkv)):
                z = y @ _rounded(att[name]["w"], precision)
                if "b" in att[name]:
                    z = z + att[name]["b"]
                qkv.append(z.view(len(x), heads, hd))
            q, k, v = qkv
            o = _attention(_rope(q, theta), _rope(k, theta), v)
            x = x + o.reshape(len(x), h * hd) @ _rounded(att["wo"]["w"],
                                                         precision)
            y = _rmsnorm(x, p["ln2"]["scale"], eps)
            x = x + _swiglu(y, *(_rounded(p["ffn"][n]["w"], precision)
                                 for n in ("w_gate", "w_up", "w_down")))
            xs[j] = x
        del p
    top = W.top_f32(cfg, seed, device)
    head = _rounded(top["lm_head"]["w"], precision)
    out = []
    for x, pos in zip(xs, positions):
        sel = torch.tensor(pos, dtype=torch.long, device=device)
        y = _rmsnorm(x[sel], top["final_norm"]["scale"], eps)
        out.append(y @ head)
    return out

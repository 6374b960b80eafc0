"""The numbers that decide ``correct`` for a served model."""
from __future__ import annotations

import torch


def gaps(ref_logits: list, tokens: list) -> torch.Tensor:
    """Each served token's gap below the reference's best logit at its
    position: ``ref_logits[i]`` [n_i, V] at the positions that produced
    ``tokens[i]``; all tokens' gaps in one vector."""
    out = []
    for lg, tok in zip(ref_logits, tokens):
        t = torch.as_tensor(tok, dtype=torch.long, device=lg.device)
        out.append(lg.max(-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out) if out else torch.zeros(0)


def widest_gap(ref_logits: list, tokens: list) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best logit at its position, over every served token."""
    g = gaps(ref_logits, tokens)
    return float(g.max()) if g.numel() else 0.0


def readings(ref_logits: list, tokens: list) -> dict:
    """The widest gap, the mean gap and the share of tokens that are not
    the reference's first choice."""
    g = gaps(ref_logits, tokens)
    if not g.numel():
        return {"widest": 0.0, "mean": 0.0, "not_first": 0.0}
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "not_first": float((g > 0).float().mean())}


def control_tokens(control_logits: list) -> list:
    """The tokens the control puts first at each position (the control
    need not decode: it reads the same prompts and served tokens)."""
    return [c.argmax(-1) for c in control_logits]

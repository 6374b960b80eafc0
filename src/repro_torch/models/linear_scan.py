"""Chunked decayed linear attention: the shared engine of Mamba2 and RWKV6.

Both families obey one recurrence over a matrix state S in R^{K x V}:

    S_t = diag(w_t) @ S_{t-1} + k_t v_t^T                  (w_t in (0,1]^K)
    y_t = q_t^T @ S_t                      (Mamba2: q=C, k=dt*B, v=x, w=exp(dt*A) per head)
    y_t = q_t^T @ (S_{t-1} + diag(u) k_t v_t^T)   (RWKV6: q=r, bonus u, per-channel decay)

The sequence is processed in chunks of Q steps: products inside a chunk,
and the f32 state carried from chunk to chunk by a Python loop (the JAX
package's inter-chunk ``lax.scan``). This is a plain computation in the
JAX package too (``jnp`` under ``lax.scan``, no Pallas kernel), so it is
plain PyTorch here.

The dtype points are the JAX package's: operands keep their input dtype,
the decay math runs in f32, every product the JAX package accumulates with
``preferred_element_type=f32`` is an f32 product here, and the scores are
cast to the input dtype before the P.V product. Where both operands are in
the input dtype (the scores with V, and SSD's q.k), the product takes them
as they are and sums in f32 (``layers.bmm_f32``: no f32 copies on the
card); where one operand is already f32, the other is cast to f32 (a
product of two bf16 values is exact in f32), as JAX promotes it.

The intra-chunk pairwise decay exp(cum_i - cum_j) is computed directly,
masked to -inf above the diagonal before the ``exp``: exact and
overflow-free, unlike the exp(cum)*exp(-cum) factorization.

Shapes: q, k, log_w: [B, T, H, K]; v: [B, T, H, V]. Returns y: [B, T, H, V]
and the final state [B, H, K, V] (f32). ``log_w`` is log-decay (<= 0),
applied to the state *before* absorbing step t's outer product.

On DTensors (sharded training, the dry run) both forms run on each rank's
own rows and heads (``sharding.local_recurrence``): the recurrence is
local to a (row, head), as attention is, so the folds and products below
only ever see local tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as S
from repro_torch.models.layers import bmm_f32

F32 = torch.float32


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, Q, H, X] -> [B*H, Q, X]."""
    b, q, h, last = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, q, last)


def _scores_v(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("bijh,bjhv->bihv") of scores s [B, Qi, Qj, H] and v
    [B, Qj, H, V], both in the input dtype, summed in f32."""
    b, qi, qj, h = s.shape
    y = bmm_f32(s.permute(0, 3, 1, 2).reshape(b * h, qi, qj),
                _heads_first(v))
    return y.reshape(b, h, qi, -1).permute(0, 2, 1, 3)


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended on the time axis (dim 1)."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_w: torch.Tensor, *,
                             chunk: int = 64,
                             bonus_u: torch.Tensor | None = None,
                             initial_state: torch.Tensor | None = None,
                             scalar_decay: bool = False,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the decayed linear-attention recurrence in chunked form.

    Args:
      q, k: [B, T, H, K]; v: [B, T, H, V]; log_w: [B, T, H, K], or [B, T, H]
        when ``scalar_decay`` (one decay per head per step: Mamba2/SSD).
      chunk: intra-chunk length.
      bonus_u: optional [H, K] RWKV-style current-token bonus. When given,
        y_t reads S_{t-1} plus diag(u) k_t v_t^T (strictly causal inside a
        chunk, j < i); when None, y_t reads S_t (Mamba2, j <= i).
      initial_state: optional [B, H, K, V].
      scalar_decay: the per-head scalar decay path: the pairwise-decay
        tensor is [B, Q, Q, H] and the scores one K-contraction.

    Returns:
      (y [B, T, H, V] in v's dtype, final_state [B, H, K, V] f32)
    """
    if S.is_dtensor(v):
        return S.local_recurrence(
            lambda q_, k_, v_, lw, st, u: chunked_linear_attention(
                q_, k_, v_, lw, chunk=chunk, bonus_u=u, initial_state=st,
                scalar_decay=scalar_decay),
            q, k, v, log_w, state=initial_state, bonus=bonus_u)
    if scalar_decay:
        return _chunked_scalar_decay(q, k, v, log_w, chunk=chunk,
                                     initial_state=initial_state)
    b, t, h, kdim = q.shape
    vdim = v.shape[-1]
    out_dtype = v.dtype
    orig_t = t
    if t % chunk:
        pad = chunk - t % chunk
        q, k, v, log_w = (_pad_time(x, pad) for x in (q, k, v, log_w))
        t = q.shape[1]
    n_chunks = t // chunk

    def to_chunks(x, last):
        return x.reshape(b, n_chunks, chunk, h, last)

    qc, kc, vc = to_chunks(q, kdim), to_chunks(k, kdim), to_chunks(v, vdim)
    lw = to_chunks(log_w, kdim).to(F32)

    idx = torch.arange(chunk, device=q.device)
    strict = bonus_u is not None
    causal = (idx[:, None] > idx[None, :]) if strict else \
        (idx[:, None] >= idx[None, :])
    u = None if bonus_u is None else bonus_u.to(F32)
    state = (torch.zeros((b, h, kdim, vdim), dtype=F32, device=q.device)
             if initial_state is None else initial_state.to(F32))

    ys = []
    for c in range(n_chunks):
        qn, kn, vn, lwn = qc[:, c], kc[:, c], vc[:, c], lw[:, c]
        dt = qn.dtype
        qf, kf, vf = qn.to(F32), kn.to(F32), vn.to(F32)
        cum = torch.cumsum(lwn, dim=1)                 # [B,Q,H,K] inclusive of i
        total = cum[:, -1]                             # [B,H,K]
        # read-side exponent: Mamba2 reads S_i (inclusive decay); RWKV6
        # reads S_{i-1}, the exclusive cumsum (one fewer decay factor)
        cum_read = cum - lwn if strict else cum

        # inter-chunk: y_i += (q_i * exp(cum_read_i)) @ S_prev
        y_inter = torch.einsum("bihk,bhkv->bihv", qf * torch.exp(cum_read),
                               state)

        # intra-chunk: s_ij = sum_K q_i k_j exp(cum_read_i - cum_j), i (>=|>) j
        diff = cum_read[:, :, None] - cum[:, None, :]  # [B,Qi,Qj,H,K]
        diff = torch.where(causal[None, :, :, None, None], diff,
                           float("-inf"))
        s = torch.einsum("bijhk,bjhk->bijh", qf[:, :, None] * torch.exp(diff),
                         kf)
        y_intra = _scores_v(s.to(dt), vn)
        if u is not None:
            yb = (qf * u * kf).sum(-1)                 # [B,Q,H]
            y_intra = y_intra + yb[..., None] * vf

        # chunk summary: S_chunk = sum_j diag(exp(total - cum_j)) k_j v_j^T
        kdec = kf * torch.exp(total[:, None] - cum)
        s_chunk = torch.einsum("bjhk,bjhv->bhkv", kdec, vf)
        state = state * torch.exp(total)[..., None] + s_chunk
        ys.append((y_intra + y_inter).to(out_dtype))

    y = torch.cat(ys, dim=1)
    return y[:, :orig_t], state


def _chunked_scalar_decay(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_w: torch.Tensor, *, chunk: int,
                          initial_state: torch.Tensor | None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD path: decay is scalar per (step, head); log_w: [B, T, H]."""
    b, t, h, kdim = q.shape
    vdim = v.shape[-1]
    out_dtype = v.dtype
    orig_t = t
    if t % chunk:
        pad = chunk - t % chunk
        q, k, v, log_w = (_pad_time(x, pad) for x in (q, k, v, log_w))
        t = q.shape[1]
    n_chunks = t // chunk

    def to_chunks(x, last):
        return x.reshape(b, n_chunks, chunk, h, last)

    qc, kc, vc = to_chunks(q, kdim), to_chunks(k, kdim), to_chunks(v, vdim)
    lw = log_w.reshape(b, n_chunks, chunk, h).to(F32)

    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]
    state = (torch.zeros((b, h, kdim, vdim), dtype=F32, device=q.device)
             if initial_state is None else initial_state.to(F32))

    ys = []
    for c in range(n_chunks):
        qn, kn, vn, lwn = qc[:, c], kc[:, c], vc[:, c], lw[:, c]
        dt = qn.dtype
        qf, kf, vf = qn.to(F32), kn.to(F32), vn.to(F32)
        cum = torch.cumsum(lwn, dim=1)                 # [B,Q,H]
        total = cum[:, -1]                             # [B,H]

        # inter-chunk: y_i += (q_i * exp(cum_i)) @ S_prev
        y_inter = torch.einsum("bihk,bhkv->bihv",
                               qf * torch.exp(cum)[..., None], state)

        # intra-chunk: s_ij = (q_i . k_j) * exp(cum_i - cum_j), i >= j
        dots = bmm_f32(_heads_first(qn), _heads_first(kn).transpose(1, 2))
        dots = dots.reshape(b, h, chunk, chunk).permute(0, 2, 3, 1)
        diff = cum[:, :, None] - cum[:, None, :]       # [B,Qi,Qj,H]
        diff = torch.where(causal[None, :, :, None], diff, float("-inf"))
        s = (dots * torch.exp(diff)).to(dt)
        y_intra = _scores_v(s, vn)

        # chunk summary + state update
        kdec = kf * torch.exp(total[:, None] - cum)[..., None]
        s_chunk = torch.einsum("bjhk,bjhv->bhkv", kdec, vf)
        state = state * torch.exp(total)[..., None, None] + s_chunk
        ys.append((y_intra + y_inter).to(out_dtype))

    y = torch.cat(ys, dim=1)
    return y[:, :orig_t], state


def linear_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_w: torch.Tensor, state: torch.Tensor, *,
                          bonus_u: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the same recurrence.

    q, k, log_w: [B, H, K]; v: [B, H, V]; state: [B, H, K, V].
    Returns (y [B, H, V] in v's dtype, new_state [B, H, K, V] in f32).
    """
    if S.is_dtensor(v):
        return S.local_recurrence(
            lambda q_, k_, v_, lw, st, u: linear_attention_step(
                q_, k_, v_, lw, st, bonus_u=u),
            q, k, v, log_w, state=state, bonus=bonus_u)
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    w = torch.exp(log_w.to(F32))
    outer = kf[..., :, None] * vf[..., None, :]        # [B,H,K,V]
    new_state = state * w[..., None] + outer
    if bonus_u is not None:
        read = state + bonus_u.to(F32)[..., :, None] * outer
    else:
        read = new_state
    y = torch.einsum("bhk,bhkv->bhv", qf, read)
    return y.to(v.dtype), new_state

"""Mamba2 — state-space duality (SSD), chunked parallel form + decode step.

The reference package's ``nn/ssm.py`` on PyTorch: the SSD algorithm of
"Transformers are SSMs" (arXiv:2405.21060), the selective SSM
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t        h: [H, P, N]
    y_t = C_t . h_t + D x_t
evaluated in O(T) by splitting time into chunks: a quadratic
(attention-like) intra-chunk term with the 1-semiseparable decay mask L,
and an inter-chunk recurrence over per-chunk states (a Python loop where
the reference scans). The casts are the reference's: the intra-chunk
product in the input dtype, the states and the output sum in float32.

Shapes: x [B, T, H, P]; A [H]; B, C [B, T, G, N] (G groups, GQA-style);
dt [B, T, H]. chunk = Q. Decode carries state [B, H, P, N]: O(1) a token.

On DTensors (under ``sharding.use_rules``) the scan and the decode step
each run as one local region a rank (``sharding.local_region``): the
recurrence is independent across batch rows, and across heads where the
groups are one (each head then reads the same B and C); the rows split
over "batch" and, where "ssm_heads" divides the heads, the heads over it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.program import resolve_device
from repro_torch.distributed import sharding


def _region_axes(mesh, batch: int, heads: int, groups: int):
    """(the batch's mesh dims, the heads' or None) of the SSD's local
    region under the active rules."""
    rules = sharding.current_rules() or {}
    b0 = sharding.batch_entry(mesh, batch)
    hx = sharding.spec_for("ssm_heads", rules=rules)[0] if rules else None
    if hx is not None and (groups != 1 or heads % sharding.spec_shards(
            hx, mesh)):
        hx = None
    return b0, hx


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} a[..., k] (j <= i).

    Returns -inf above the diagonal; exp(segsum) is the lower-triangular
    decay mask L of the SSD dual form.
    """
    t = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]     # sum over (j, i]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. Returns (y [B,T,H,P], final_state [B,H,P,N])."""
    if sharding.is_dtensor(x):
        b0, hx = _region_axes(x.device_mesh, x.shape[0], x.shape[2],
                              b.shape[2])
        return sharding.local_region(
            lambda *t: ssd_chunked(*t[:5], chunk=chunk, initial_state=t[5]),
            [(x, (b0, None, hx, None)), (dt, (b0, None, hx)), (a, (hx,)),
             (b, (b0, None, None, None)), (c, (b0, None, None, None)),
             (initial_state, (b0, hx, None, None))],
            [(b0, None, hx, None), (b0, hx, None, None)])
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if t % chunk:
        raise ValueError(f"T({t}) must divide chunk({chunk})")
    nc = t // chunk
    hg = h // g                                           # heads per group

    # chunked views --------------------------------------------------------
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, g, n)
    cc = c.reshape(bsz, nc, chunk, g, n)

    da = dtc * a[None, None, None, :]                     # [B,nc,Q,H] (<0)
    da = da.movedim(-1, -2)                               # [B,nc,H,Q]
    da_cs = torch.cumsum(da, dim=-1)                      # [B,nc,H,Q]

    # 1) intra-chunk (diagonal blocks): attention-like with decay mask -----
    l_mask = torch.exp(segsum(da))                        # [B,nc,H,Q,Q]
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", cc, bc)       # [B,nc,G,Q,Q]
    cb = torch.repeat_interleave(cb, hg, dim=2)           # [B,nc,H,Q,Q]
    dtx = xc * dtc[..., None]                             # x * dt
    scores = cb * l_mask
    y_diag = torch.einsum("bchqs,bcshp->bcqhp",
                          scores.to(x.dtype), dtx.to(x.dtype))

    # 2) per-chunk states: what each chunk contributes to the carried state
    bh = torch.repeat_interleave(bc, hg, dim=3)           # [B,nc,Q,H,N]
    ch = torch.repeat_interleave(cc, hg, dim=3)
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)     # [B,nc,H,Q]
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn",
                          bh.float(),
                          decay_states.float() * dtc.movedim(-1, -2).float(),
                          xc.float())                     # [B,nc,H,P,N]

    # 3) inter-chunk recurrence over carried states -------------------------
    chunk_decay = torch.exp(da_cs[..., -1])               # [B,nc,H]
    carry = (initial_state if initial_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device))
    prev = []
    for i in range(nc):                                   # emit PREVIOUS state
        prev.append(carry)
        carry = carry * chunk_decay[:, i][..., None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                # [B,nc,H,P,N]

    # 4) inter-chunk output: C_t . (decay-to-t applied to incoming state) ---
    state_decay = torch.exp(da_cs)                        # [B,nc,H,Q]
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp",
                         ch.float(), prev_states, state_decay.float())

    y = (y_diag.float() + y_off).reshape(bsz, t, h, p)
    return y.to(x.dtype), carry


def ssd_reference(x, dt, a, b, c, initial_state=None):
    """O(T) sequential oracle (slow; tests only)."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    state = (initial_state if initial_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for i in range(t):
        da = torch.exp(dt[:, i] * a[None, :])             # [B,H]
        bi = torch.repeat_interleave(b[:, i], hg, dim=1)  # [B,H,N]
        ci = torch.repeat_interleave(c[:, i], hg, dim=1)
        upd = (dt[:, i][..., None, None] * x[:, i][..., None]
               * bi[:, :, None, :])                       # [B,H,P,N]
        state = state * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ci))
    y = torch.stack(ys, dim=1)                            # [B,T,H,P]
    return y.to(x.dtype), state


class SSMState(NamedTuple):
    """Decode-time cache: conv window + SSM state."""
    conv: torch.Tensor       # [B, K-1, conv_dim]
    ssm: torch.Tensor        # [B, H, P, N] float32
    pos: torch.Tensor        # [] int32

    @classmethod
    def init(cls, batch: int, conv_k: int, conv_dim: int, heads: int,
             head_dim: int, state: int, dtype=torch.bfloat16, device="cuda"):
        device = resolve_device(device)
        return cls(torch.zeros((batch, conv_k - 1, conv_dim), dtype=dtype,
                               device=device),
                   torch.zeros((batch, heads, head_dim, state),
                               dtype=torch.float32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """One recurrent step. x [B,H,P]; dt [B,H]; b,c [B,G,N]; state [B,H,P,N].

    Returns (y [B,H,P], new_state). O(H*P*N) — independent of context length.
    """
    if sharding.is_dtensor(x):
        b0, hx = _region_axes(x.device_mesh, x.shape[0], x.shape[1],
                              b.shape[1])
        return sharding.local_region(
            ssd_decode_step,
            [(state, (b0, hx, None, None)), (x, (b0, hx, None)),
             (dt, (b0, hx)), (a, (hx,)), (b, (b0, None, None)),
             (c, (b0, None, None))],
            [(b0, hx, None), (b0, hx, None, None)])
    h = x.shape[1]
    hg = h // b.shape[1]
    da = torch.exp(dt * a[None, :])                       # [B,H]
    bi = torch.repeat_interleave(b, hg, dim=1)            # [B,H,N]
    ci = torch.repeat_interleave(c, hg, dim=1)
    upd = (dt[..., None, None] * x[..., None]) * bi[:, :, None, :]
    new_state = state * da[..., None, None] + upd.float()
    y = torch.einsum("bhpn,bhn->bhp", new_state, ci.float())
    return y.to(x.dtype), new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: [B, T, C]; w: [K, C] -> [B, T, C]; the
    taps summed in float32 one after another, as the reference."""
    k = w.shape[0]
    t = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + t, :].float() * w[i][None, None, :]
    if bias is not None:
        out = out + bias[None, None, :]
    return out.to(x.dtype)


def causal_conv1d_step(conv_state: torch.Tensor, x_new: torch.Tensor,
                       w: torch.Tensor, bias: Optional[torch.Tensor] = None):
    """Decode step for the depthwise conv. conv_state [B,K-1,C], x_new [B,C].
    The window takes the wider of the two dtypes, as a concatenation does
    in the reference."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # [B,K,C]
    y = torch.einsum("bkc,kc->bc", window.float(), w)
    if bias is not None:
        y = y + bias[None, :]
    return y.to(x_new.dtype), window[:, 1:, :]

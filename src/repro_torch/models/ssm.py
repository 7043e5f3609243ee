"""Mamba-2 (SSD, state-space duality) mixer — chunked training form +
O(1)-state decode.

The port of ``repro.models.ssm``. The fused Mamba in_proj stays split into
per-output projections (z / x / B / C / dt), as in the reference (whose
split serves its tensor-parallel sharding); the leaves and their values
are the reference's. The reference runs no Pallas kernel here, and the
port writes none: the chunked form is batched products over the chunk
axis and a cheap elementwise state recurrence between chunks.

Numerics, held to the reference's:

* The reference's einsums take compute-dtype operands with
  ``preferred_element_type=float32`` and return float32; the port upcasts
  the operands to float32 first. A product of two bf16 values (or of
  three: 24 significant bits) is exact in float32, so only the order of
  the float32 sums differs. The reference's roundings to the compute
  dtype are kept: the intra-chunk decay ``l_mat``, the scores
  ``cb * l_mat``, ``decay_to_end`` and ``exp(acum)``. On the card the
  float32 products run in full float32 when TF32 is off, as
  ``chip_smoke.py`` sets it.
* ``seg`` is clamped to 0 above the diagonal before ``exp``: the masked
  entries are positive, and ``exp`` of them would leak inf (NaN in the
  backward) through the ``where``.
* The reference's ``lax.scan`` over chunks is a Python loop over
  ``S / ssm_chunk`` chunks (16 at 2048 tokens and chunk 128).
* ``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns x
  itself above 20, where the two differ by less than float32's ulp.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import Param, dense, rmsnorm

__all__ = ["ssm_t", "ssm_forward", "ssm_decode", "init_ssm_cache"]


def ssm_t(cfg: ModelConfig) -> Dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv_width
    return {
        "z_proj": {"w": Param((d, di))},
        "x_proj": {"w": Param((d, di))},
        "b_proj": {"w": Param((d, n))},
        "c_proj": {"w": Param((d, n))},
        "dt_proj": {"w": Param((d, h))},
        "conv_x": Param((cw, di), "normal:0.2"),
        "conv_b": Param((cw, n), "normal:0.2"),
        "conv_c": Param((cw, n), "normal:0.2"),
        "a_log": Param((h,), "zeros"),
        "d_skip": Param((h,), "ones"),
        "dt_bias": Param((h,), "zeros"),
        "norm": {"scale": Param((di,), "ones")},
        "out_proj": {"w": Param((di, d))},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: [B, S, C], w: [cw, C]."""
    cw = w.shape[0]
    out = x * w[-1]
    for i in range(cw - 1):
        shift = cw - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]] * w[i]
    return out


def _post(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm + out projection (y, z: [..., d_inner])."""
    g = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z.float()).to(y.dtype)
    return dense(p["out_proj"], g.to(z.dtype))


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD. x: [B, S, D]; S % ssm_chunk == 0."""
    b, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, f"seq {s} % chunk {q}"
    nc = s // q
    dt_c, f32 = x.dtype, torch.float32

    z = dense(p["z_proj"], x)
    xc = F.silu(_causal_conv(dense(p["x_proj"], x), p["conv_x"].to(dt_c)))
    bmat = F.silu(_causal_conv(dense(p["b_proj"], x), p["conv_b"].to(dt_c)))
    cmat = F.silu(_causal_conv(dense(p["c_proj"], x), p["conv_c"].to(dt_c)))
    dt_raw = dense(p["dt_proj"], x)  # [B,S,H]

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())  # [H]
    da = dt * a  # ≤ 0
    xh = xc.reshape(b, s, h, pdim)

    # Chunk: x stays in the compute dtype; the decay statistics are float32.
    xhc = xh.reshape(b, nc, q, h, pdim).float()
    dtc = dt.reshape(b, nc, q, h)
    dac = da.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    acum = torch.cumsum(dac, dim=2)  # [B,nC,Q,H] f32
    # --- intra-chunk (quadratic-in-Q attention-like form) ----------------
    seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]  # [B,nC,Qi,Qj,H]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[
        None, None, :, :, None]
    # Clamp BEFORE exp (see the module docstring).
    seg = torch.where(causal, seg, 0.0)
    l_mat = (torch.where(causal, torch.exp(seg), 0.0)
             * dtc[:, :, None, :, :]).to(dt_c)  # decay(i<-j) * dt_j
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # [B,nC,Q,Q] f32
    scores = cb[..., None].to(dt_c) * l_mat  # [B,nC,Qi,Qj,H], compute dtype
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.float(), xhc)

    # --- chunk-local end states ------------------------------------------
    a_last = acum[:, :, -1:, :]  # [B,nC,1,H]
    decay_to_end = (torch.exp(a_last - acum) * dtc).to(dt_c).float()  # [B,nC,Q,H]
    s_loc = torch.einsum("bcjhn,bcjhp->bchnp",
                         decay_to_end[..., None] * bc[:, :, :, None, :], xhc)

    # --- inter-chunk state propagation (the reference's scan) ------------
    decay = torch.exp(acum[:, :, -1, :])  # [B,nC,H]
    carry = torch.zeros((b, h, n, pdim), dtype=f32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(carry)
        carry = s_loc[:, c] + decay[:, c, :, None, None] * carry
    h_in = torch.stack(h_in, dim=1)  # [B,nC,H,N,P]: the state entering each chunk

    # --- inter-chunk output (batched, outside the loop) ------------------
    y_inter = (torch.einsum("bcin,bchnp->bcihp", cc, h_in)
               * torch.exp(acum).to(dt_c).float()[..., None])

    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(dt_c)
    return _post(p, y, z, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_ssm_cache(
    cfg: ModelConfig, batch: int, n_ssm_layers: int, dtype, device
) -> Dict[str, torch.Tensor]:
    """SSM states (float32) and conv windows (``dtype``), stacked over the
    SSM layers, on ``device``."""
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cw = cfg.ssm_conv_width
    return {
        "state": torch.zeros((n_ssm_layers, batch, h, n, pdim), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_ssm_layers, batch, cw - 1, di + 2 * n), dtype=dtype,
                            device=device),
    }


def ssm_decode(
    p,
    x: torch.Tensor,  # [B, 1, D]
    state: torch.Tensor,  # [B, H, N, P] f32
    conv: torch.Tensor,  # [B, cw-1, di+2N]
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. Returns (y, new state, new conv window); the
    inputs are left as they are."""
    b = x.shape[0]
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z = dense(p["z_proj"], x)
    xbc_new = torch.cat(
        [dense(p["x_proj"], x), dense(p["b_proj"], x), dense(p["c_proj"], x)], dim=-1
    )  # [B,1,di+2N]
    window = torch.cat([conv, xbc_new], dim=1)  # [B,cw,di+2N]
    conv_w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=1).to(window.dtype)
    # einsum("bsc,sc->bc") in the window's dtype: float32 sums, one rounding.
    xbc = F.silu((window.float() * conv_w.float()).sum(dim=1).to(window.dtype))[:, None, :]
    conv_next = window[:, 1:]
    xc, bmat, cmat = xbc[..., :di], xbc[..., di: di + n], xbc[..., di + n:]

    dt_raw = dense(p["dt_proj"], x)[:, 0]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # [B,H]
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a)  # [B,H]
    xh = xc.reshape(b, h, pdim).float()
    bv = bmat[:, 0].float()  # [B,N]
    cv = cmat[:, 0].float()
    state = decay[:, :, None, None] * state + (
        dt[:, :, None, None] * bv[:, None, :, None] * xh[:, :, None, :]
    )
    y = torch.einsum("bn,bhnp->bhp", cv, state)
    y = y + p["d_skip"].float()[None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    return _post(p, y, z, cfg), state, conv_next

"""Mamba2 (SSD) block (twin of ``repro/models/ssm.py``): the chunked scan
for scoring and training, the O(1) recurrent state update for decode.  Used
by zamba2-7b.

State space, per head h with head dim p and state dim N:
  S_t = a_t * S_{t-1} + dt_t * x_t ⊗ B_t      (a_t = exp(dt_t * A_h), A_h < 0)
  y_t = C_t · S_t + D_h * x_t

The chunked form computes, per chunk of Q tokens, an intra-chunk quadratic
(attention-like) term plus the carried state's contribution, and updates
the carry once a chunk: a Python loop over the chunks where JAX scans.
Every decay is exp of a non-positive number, so the scan is stable.

The projections go through ``linear_apply`` (the sparse linear kernel on
the card); the scan, the depthwise causal conv and the gates are plain
PyTorch, as the JAX package computes them in XLA, outside any Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import box, linear_apply, linear_init
from repro_torch.models.common import norm_apply, norm_init

NEG = -1e30


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def mamba_init(generator: torch.Generator, cfg: ModelConfig, device=None):
    """``{"in_proj", "out_proj", "conv_w", "conv_b", "A_log", "D",
    "dt_bias", "norm"}``: ``A_log``, ``D`` and ``dt_bias`` are float32
    whatever ``param_dtype`` is, as in the JAX package."""
    d = cfg.d_model
    di, nh, ns = mamba_dims(cfg)
    conv_ch = di + 2 * ns
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    opts = dict(dtype=dtype, device=dev)
    d_in_proj = 2 * di + 2 * ns + nh  # z, x, B, C, dt
    in_proj = linear_init(generator, d, d_in_proj, cfg.sparsity,
                          in_ax="embed", out_ax="ffn", **opts)
    out_proj = linear_init(generator, di, d, cfg.sparsity, in_ax="ffn",
                           out_ax="embed", mode="reduce", **opts)
    conv_w = torch.randn((cfg.d_conv, conv_ch), generator=generator,
                         dtype=torch.float32) * 0.1
    return {
        "in_proj": in_proj,
        "out_proj": out_proj,
        "conv_w": box(conv_w.to(dev, dtype), (None, "ffn")),
        "conv_b": box(torch.zeros((conv_ch,), dtype=dtype, device=dev),
                      ("ffn",)),
        "A_log": box(torch.log(torch.linspace(1.0, 16.0, nh)).to(dev),
                     (None,)),
        "D": box(torch.ones((nh,), dtype=torch.float32, device=dev), (None,)),
        "dt_bias": box(torch.zeros((nh,), dtype=torch.float32, device=dev),
                       (None,)),
        "norm": norm_init(di, "rmsnorm", dtype, dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S. x [B, S, C]; w [K, C]; summed tap by
    tap in the operands' dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, nh, ns = mamba_dims(cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns:]
    return z, xbc, dt


def _chunk_len(chunk: int, s: int) -> int:
    """The largest chunk length up to ``chunk`` that divides ``s``."""
    q = min(chunk, s)
    while s % q != 0:
        q -= 1
    return q


def mamba_apply(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Scoring / training forward. hidden [B, S, d_model]."""
    b, s, _ = hidden.shape
    di, nh, ns = mamba_dims(cfg)
    p = cfg.ssm_head_dim
    q = _chunk_len(cfg.ssm_chunk, s)
    nc = s // q
    f32 = torch.float32

    zxbcdt = linear_apply(params["in_proj"], hidden)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(F.silu(xbc), params["conv_w"], params["conv_b"])
    x = xbc[..., :di].reshape(b, s, nh, p)
    bm = xbc[..., di:di + ns]  # [B, S, N]
    cm = xbc[..., di + ns:]  # [B, S, N]

    a_neg = -torch.exp(params["A_log"].float())  # [H] < 0
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B, S, H]
    log_a = dt * a_neg[None, None, :]  # [B, S, H] <= 0

    xc = x.reshape(b, nc, q, nh, p).to(f32)
    bc = bm.reshape(b, nc, q, ns).to(f32)
    cc = cm.reshape(b, nc, q, ns).to(f32)
    dtc = dt.reshape(b, nc, q, nh)
    lac = log_a.reshape(b, nc, q, nh)
    mask = (torch.arange(q, device=hidden.device)[:, None]
            >= torch.arange(q, device=hidden.device)[None, :])[None, :, :, None]

    state = torch.zeros((b, nh, p, ns), dtype=f32, device=hidden.device)
    ys = []
    for c in range(nc):
        xq, bq, cq, dtq, laq = (t[:, c] for t in (xc, bc, cc, dtc, lac))
        g = torch.cumsum(laq, dim=1)  # [B, Q, H] cumulative log-decay
        # the carried state's contribution: y_state[i] = exp(g_i) C_i . S
        y_state = (torch.einsum("bqn,bhpn->bqhp", cq, state)
                   * torch.exp(g)[..., None])
        # intra-chunk: L[i, j] = exp(g_i - g_j) for j <= i.  The exponent is
        # masked, not the exp: exp of a masked-out large positive delta
        # would overflow and give the backward inf * 0 = NaN
        gi, gj = g[:, :, None, :], g[:, None, :, :]
        el = torch.exp(torch.where(mask, gi - gj, NEG))  # [B, Q, Q, H]
        scores = torch.einsum("bin,bjn->bij", cq, bq)  # [B, Q, Q]
        gw = scores[..., None] * el * dtq[:, None, :, :]  # weight on x_j
        y_intra = torch.einsum("bijh,bjhp->bihp", gw, xq)
        # the carry
        decay_chunk = torch.exp(g[:, -1:, :] - g)  # exp(g_Q - g_j) [B, Q, H]
        state = (torch.exp(g[:, -1, :])[:, :, None, None] * state
                 + torch.einsum("bjh,bjhp,bjn->bhpn", decay_chunk * dtq, xq, bq))
        ys.append(y_state + y_intra)
    y = torch.stack(ys, dim=1).reshape(b, s, nh, p)  # [B, S, H, p]
    y = y + params["D"][None, None, :, None] * x.to(f32)
    y = y.reshape(b, s, di).to(hidden.dtype)
    y = norm_apply(params["norm"], y * F.silu(z), "rmsnorm")
    return linear_apply(params["out_proj"], y)


# ---------------------------------------------------------------------------
# Decode (single-token recurrence)
# ---------------------------------------------------------------------------


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None):
    """``{"ssm"}`` [B, H, p, N] float32 and ``{"conv"}`` [B, d_conv - 1,
    d_inner + 2N] in ``dtype``, zeros on ``device``."""
    di, nh, ns = mamba_dims(cfg)
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, ns),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * ns), dtype=dtype,
                            device=dev),
    }


def mamba_decode(params, cfg: ModelConfig, hidden: torch.Tensor, cache):
    """hidden [B, 1, d_model] -> (out [B, 1, d], new cache).  The conv sums
    its taps in float32 here, where ``mamba_apply`` sums them in the
    operands' dtype, as in the JAX package."""
    b = hidden.shape[0]
    di, nh, ns = mamba_dims(cfg)
    p = cfg.ssm_head_dim
    f32 = torch.float32

    zxbcdt = linear_apply(params["in_proj"], hidden)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = F.silu(xbc)  # [B, 1, C]
    conv_hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    xbc_c = torch.einsum("bkc,kc->bc", conv_hist.to(f32),
                         params["conv_w"].to(f32))
    xbc_c = (xbc_c + params["conv_b"].to(f32))[:, None, :]
    new_conv = conv_hist[:, 1:, :]

    x = xbc_c[..., :di].reshape(b, nh, p)
    bm = xbc_c[:, 0, di:di + ns]  # [B, N]
    cm = xbc_c[:, 0, di + ns:]
    a_neg = -torch.exp(params["A_log"].float())
    dtv = F.softplus(dt[:, 0, :].float() + params["dt_bias"])  # [B, H]
    a = torch.exp(dtv * a_neg[None, :])  # [B, H]

    s_new = a[:, :, None, None] * cache["ssm"] + torch.einsum(
        "bh,bhp,bn->bhpn", dtv, x, bm)
    y = torch.einsum("bn,bhpn->bhp", cm, s_new) + params["D"][None, :, None] * x
    y = y.reshape(b, 1, di).to(hidden.dtype)
    y = norm_apply(params["norm"], y * F.silu(z), "rmsnorm")
    return linear_apply(params["out_proj"], y), {"ssm": s_new, "conv": new_conv}

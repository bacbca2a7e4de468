"""xLSTM blocks (twin of ``repro/models/xlstm.py``): mLSTM (matrix memory,
exponential gating) in a chunked parallel form, and sLSTM (scalar memory,
recurrent mixing) as a loop over time.

mLSTM recurrence (per head, head dim p):
  m_t = max(lf_t + m_{t-1}, i_t)                       (log-scale stabiliser)
  C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) v_t k_t^T
  n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(i_t - m_t) k_t
  y_t = C_t q_t / max(|n_t . q_t|, exp(-m_t))

The chunked form evaluates the intra-chunk part as a masked attention-like
quadratic with log-domain weights D[i, j] = g_i - g_j + i_j (g the cumsum
of the log forget gate), the carried state with its own log scale, and is
sequential only over the chunks (a Python loop where JAX scans).  Decode is
the plain one-step recurrence.

The projections go through ``linear_apply`` (the sparse linear kernel on
the card); the scans, the gates and the sLSTM's recurrent ``r`` matmul are
plain PyTorch, as the JAX package computes them in XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import box, linear_apply, linear_init
from repro_torch.models.common import norm_apply, norm_init
from repro_torch.models.ssm import _chunk_len

NEG = -1e30


def xlstm_dims(cfg: ModelConfig):
    d_inner = cfg.expand * cfg.d_model
    n_heads = cfg.padded_heads
    return d_inner, n_heads, d_inner // n_heads


def _randn(generator, shape, scale, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
    return w.to(device, dtype)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the operands' promoted dtype, as ``jnp.matmul`` takes
    mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(generator: torch.Generator, cfg: ModelConfig, device=None):
    """``{"up", "q", "k", "v", "gates", "gates_b", "norm", "down"}``;
    ``gates_b`` is float32 whatever ``param_dtype`` is."""
    d = cfg.d_model
    di, nh, _ = xlstm_dims(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    scfg = cfg.sparsity
    opts = dict(dtype=dtype, device=dev)
    p = {
        "up": linear_init(generator, d, 2 * di, scfg, in_ax="embed",
                          out_ax="ffn", **opts),
        "q": linear_init(generator, di, di, scfg, in_ax="ffn",
                         out_ax="heads_flat", **opts),
        "k": linear_init(generator, di, di, scfg, in_ax="ffn",
                         out_ax="heads_flat", **opts),
        "v": linear_init(generator, di, di, scfg, in_ax="ffn",
                         out_ax="heads_flat", **opts),
        "gates": box(_randn(generator, (di, 2 * nh), 0.01, dtype, dev),
                     ("ffn", None)),
        "gates_b": box(torch.cat([torch.full((nh,), 3.0),
                                  torch.zeros((nh,))]).to(dev), (None,)),
        "norm": norm_init(di, "rmsnorm", dtype, dev),
    }
    p["down"] = linear_init(generator, di, d, scfg, in_ax="ffn",
                            out_ax="embed", mode="reduce", **opts)
    return p


def _mlstm_qkvg(params, cfg: ModelConfig, hidden):
    b, s, _ = hidden.shape
    di, nh, p = xlstm_dims(cfg)
    up = linear_apply(params["up"], hidden)
    xi, z = up[..., :di], up[..., di:]
    q = linear_apply(params["q"], xi).reshape(b, s, nh, p)
    k = linear_apply(params["k"], xi).reshape(b, s, nh, p) / math.sqrt(p)
    v = linear_apply(params["v"], xi).reshape(b, s, nh, p)
    gates = _matmul(xi, params["gates"]) + params["gates_b"]  # [B, S, 2H]
    lf = F.logsigmoid(gates[..., :nh].float())  # log forget
    ig = gates[..., nh:].float()  # input gate (log domain)
    return q, k, v, lf, ig, z


def mlstm_apply(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    b, s, _ = hidden.shape
    di, nh, p = xlstm_dims(cfg)
    qq = _chunk_len(cfg.ssm_chunk, s)
    nc = s // qq
    f32 = torch.float32
    dev = hidden.device

    q, k, v, lf, ig, z = _mlstm_qkvg(params, cfg, hidden)
    qc = q.reshape(b, nc, qq, nh, p).to(f32)
    kc = k.reshape(b, nc, qq, nh, p).to(f32)
    vc = v.reshape(b, nc, qq, nh, p).to(f32)
    lfc = lf.reshape(b, nc, qq, nh)
    igc = ig.reshape(b, nc, qq, nh)
    mask = (torch.arange(qq, device=dev)[:, None]
            >= torch.arange(qq, device=dev)[None, :])[None, :, :, None]

    C = torch.zeros((b, nh, p, p), dtype=f32, device=dev)
    n = torch.zeros((b, nh, p), dtype=f32, device=dev)
    m = torch.zeros((b, nh), dtype=f32, device=dev)
    ys = []
    for c in range(nc):
        qx, kx, vx, lfx, igx = (t[:, c] for t in (qc, kc, vc, lfc, igc))
        g = torch.cumsum(lfx, dim=1)  # [B, Q, H]
        # log weights, masked before the exp (exp of NEG is 0, its
        # gradient too)
        d_intra = g[:, :, None, :] - g[:, None, :, :] + igx[:, None, :, :]
        d_intra = torch.where(mask, d_intra, NEG)  # [B, i, j, H]
        d_state = g + m[:, None, :]  # [B, Q, H]
        m_i = torch.maximum(d_intra.amax(dim=2), d_state)  # [B, Q, H]
        m_i = torch.maximum(m_i, -m_i * 0)  # clamp at 0: sane denominators
        w_intra = torch.exp(d_intra - m_i[:, :, None, :])  # [B, i, j, H]
        w_state = torch.exp(d_state - m_i)  # [B, Q, H]
        scores = torch.einsum("bihp,bjhp->bijh", qx, kx)  # [B, i, j, H]
        num = torch.einsum("bijh,bijh,bjhp->bihp", scores, w_intra, vx)
        # C is stored as v ⊗ k ([b, h, p = v dim, r = k dim]): q contracts
        # the key dim r
        num = num + w_state[..., None] * torch.einsum("bhpr,bihr->bihp", C, qx)
        den = torch.einsum("bijh,bijh->bih", scores, w_intra)
        den = den + w_state * torch.einsum("bhp,bihp->bih", n, qx)
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_i))[..., None])
        # the carry
        g_last = g[:, -1, :]  # [B, H]
        m_new = torch.maximum(g_last + m,
                              (g_last[:, None, :] - g + igx).amax(dim=1))
        decay_c = torch.exp(g_last + m - m_new)  # [B, H]
        w_new = torch.exp(g_last[:, None, :] - g + igx
                          - m_new[:, None, :])  # [B, Q, H]
        C = (decay_c[:, :, None, None] * C
             + torch.einsum("bjh,bjhp,bjhr->bhpr", w_new, vx, kx))
        n = decay_c[:, :, None] * n + torch.einsum("bjh,bjhp->bhp", w_new, kx)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, s, di).to(hidden.dtype)
    y = norm_apply(params["norm"], y, "rmsnorm") * F.silu(z)
    return linear_apply(params["down"], y)


def mlstm_cache_init(cfg: ModelConfig, batch: int, device=None):
    """``{"C"}`` [B, H, p, p], ``{"n"}`` [B, H, p] and ``{"m"}`` [B, H],
    float32 zeros on ``device``."""
    _, nh, p = xlstm_dims(cfg)
    dev = resolve_device(device)
    return {
        "C": torch.zeros((batch, nh, p, p), dtype=torch.float32, device=dev),
        "n": torch.zeros((batch, nh, p), dtype=torch.float32, device=dev),
        "m": torch.zeros((batch, nh), dtype=torch.float32, device=dev),
    }


def mlstm_decode(params, cfg: ModelConfig, hidden: torch.Tensor, cache):
    """hidden [B, 1, d_model] -> (out [B, 1, d], new cache)."""
    b = hidden.shape[0]
    di, nh, p = xlstm_dims(cfg)
    q, k, v, lf, ig, z = _mlstm_qkvg(params, cfg, hidden)
    qx, kx, vx = (t[:, 0].float() for t in (q, k, v))  # [B, H, p]
    lfx, igx = lf[:, 0], ig[:, 0]  # [B, H]
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lfx + m, igx)
    fdec = torch.exp(lfx + m - m_new)
    iw = torch.exp(igx - m_new)
    C_new = fdec[:, :, None, None] * C + iw[:, :, None, None] * torch.einsum(
        "bhp,bhr->bhpr", vx, kx)
    n_new = fdec[:, :, None] * n + iw[:, :, None] * kx
    num = torch.einsum("bhpr,bhr->bhp", C_new, qx)
    den = torch.einsum("bhp,bhp->bh", n_new, qx)
    y = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    y = y.reshape(b, 1, di).to(hidden.dtype)
    y = norm_apply(params["norm"], y, "rmsnorm") * F.silu(z)
    return linear_apply(params["down"], y), {"C": C_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(generator: torch.Generator, cfg: ModelConfig, device=None):
    """``{"w", "r", "b", "norm", "down"}``: the recurrent mixing ``r`` is
    block-diagonal per head, [H, p, 4p]; ``b`` is float32 whatever
    ``param_dtype`` is."""
    d = cfg.d_model
    di, nh, p = xlstm_dims(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    scfg = cfg.sparsity
    opts = dict(dtype=dtype, device=dev)
    w = linear_init(generator, d, 4 * di, scfg, in_ax="embed", out_ax="ffn",
                    **opts)
    r = _randn(generator, (nh, p, 4 * p), 0.05, dtype, dev)
    down = linear_init(generator, di, d, scfg, in_ax="ffn", out_ax="embed",
                       mode="reduce", **opts)
    return {
        "w": w,
        "r": box(r, ("heads", None, None)),
        "b": box(torch.cat([torch.zeros((di,)), torch.full((di,), 3.0),
                            torch.zeros((2 * di,))]).to(dev), (None,)),
        "norm": norm_init(di, "rmsnorm", dtype, dev),
        "down": down,
    }


def _slstm_cell(params, cfg, wx_t, state):
    """One sLSTM step. wx_t [B, 4di]; state (c, n, h, m), each [B, H, p]."""
    _, nh, p = xlstm_dims(cfg)
    c, n, h, m = state
    rh = torch.einsum("bhp,hpq->bhq", h, params["r"].float())  # [B, H, 4p]
    pre = (wx_t.reshape(-1, nh, 4 * p).float() + rh
           + params["b"].reshape(nh, 4 * p).float())
    i_g, f_g, z_g, o_g = torch.chunk(pre, 4, dim=-1)  # [B, H, p] each
    lf = F.logsigmoid(f_g)
    m_new = torch.maximum(lf + m, i_g)
    i_t = torch.exp(i_g - m_new)
    f_t = torch.exp(lf + m - m_new)
    c_new = f_t * c + i_t * torch.tanh(z_g)
    n_new = f_t * n + i_t
    # torch.maximum, not clamp: at a tie (n_new is 1 at the first step) it
    # splits the gradient in halves, as jnp.maximum does
    h_new = torch.sigmoid(o_g) * c_new / torch.maximum(n_new,
                                                       n_new.new_ones(()))
    return c_new, n_new, h_new, m_new


def slstm_apply(params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    b, s, _ = hidden.shape
    di, nh, p = xlstm_dims(cfg)
    wx = linear_apply(params["w"], hidden)  # [B, S, 4di]
    z0 = torch.zeros((b, nh, p), dtype=torch.float32, device=hidden.device)
    state = (z0, z0, z0, z0)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, cfg, wx[:, t], state)
        hs.append(state[2])
    y = torch.stack(hs, dim=1).reshape(b, s, di).to(hidden.dtype)
    y = norm_apply(params["norm"], y, "rmsnorm")
    return linear_apply(params["down"], y)


def slstm_cache_init(cfg: ModelConfig, batch: int, device=None):
    """``{"c", "n", "h", "m"}``, each [B, H, p] float32 zeros of its own on
    ``device``."""
    _, nh, p = xlstm_dims(cfg)
    dev = resolve_device(device)
    return {k: torch.zeros((batch, nh, p), dtype=torch.float32, device=dev)
            for k in ("c", "n", "h", "m")}


def slstm_decode(params, cfg: ModelConfig, hidden: torch.Tensor, cache):
    """hidden [B, 1, d_model] -> (out [B, 1, d], new cache)."""
    wx = linear_apply(params["w"], hidden)[:, 0]  # [B, 4di]
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    c, n, h, m = _slstm_cell(params, cfg, wx, state)
    di, _, _ = xlstm_dims(cfg)
    y = h.reshape(-1, 1, di).to(hidden.dtype)
    y = norm_apply(params["norm"], y, "rmsnorm")
    return linear_apply(params["down"], y), {"c": c, "n": n, "h": h, "m": m}

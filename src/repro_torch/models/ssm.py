"""Mamba-2 (SSD, state-space duality) blocks: the chunked train scan and the
O(1) decode step (port of ``repro.models.ssm``).

The minimal SSD algorithm of the Mamba-2 paper (chunkwise: an intra-chunk
quadratic term plus an inter-chunk state recurrence), with a single B/C
group broadcast over the heads, a short causal depthwise conv on (x|B|C),
softplus dt with a learned bias, and a gated RMSNorm before ``out_proj``.
The scan's products are pairwise contractions (``C . B^T`` over the state,
times the decay mask, then by x), so their order of sums does not depend
on an einsum path optimizer, and the (B, H, C, L, L) decay mask is the one
large intermediate.

Decode carries ``conv`` (B, K-1, C_conv), the last pre-conv inputs, and
``ssm`` (B, H, P, N) fp32, and does the exact one-step recurrence.

On an in-pod mesh (``models/sharding.py``) the train path runs the rank's
heads, a contiguous ``H / model`` of them.  ``in_proj`` (``(data,
model)``) is column-parallel: the rank projects onto the columns it holds
and the projections are gathered over ``model`` (a half over ``model``
does not fall on head boundaries, and the one B/C group is every head's),
then the rank takes its heads' z, x and dt columns and B/C.  ``conv_w``
(``(None, model)``, small) is gathered whole and cut the same way; the
per-head vectors and ``gate_norm`` (replicated) are cut to its heads; the
gated RMSNorm's sum of squares is summed over ``model``; and
``out_proj``'s rows (``(model, data)``) are the rank's heads' already, so
its product is row-parallel, summed over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, dtype_of, full, rms_norm
from repro_torch.models.sharding import (
    cs,
    current_inpod,
    fsdp,
    model_heads,
    model_sum,
    model_whole,
    tp_enter,
)


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x | B | C


def init_mamba(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """Mamba-2 weights (stacked like ``key``), keys in sorted order:
    ``a_log`` 0 (A = -1), ``d_skip`` 1 and ``dt_bias`` 0 in fp32, the rest in
    the config dtype; ``split(key, 4)`` into in_proj, conv_w, out_proj."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt, f32 = dtype_of(cfg), torch.float32
    proj_out = 2 * di + 2 * n + h  # z | x | B | C | dt
    ks = prng.split(key, 4).unbind(-2)
    return {
        "a_log": full(key, (h,), 0.0, f32),
        "conv_b": full(key, (_conv_channels(cfg),), 0.0, dt),
        "conv_w": dense_init(ks[1], (cfg.ssm_conv_kernel, _conv_channels(cfg)), dt),
        "d_skip": full(key, (h,), 1.0, f32),
        "dt_bias": full(key, (h,), 0.0, f32),
        "gate_norm": full(key, (di,), 1.0, dt),
        "in_proj": dense_init(ks[0], (d, proj_out), dt, d),
        "out_proj": dense_init(ks[2], (di, d), dt, di),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., l) -> (..., l, l), out[i, j] = sum_{j < k <= i} x[k]; -inf above
    the diagonal (a difference of cumulative sums, as the reference)."""
    l = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    seg = csum[..., :, None] - csum[..., None, :]
    idx = torch.arange(l, device=x.device)
    mask = idx[:, None] >= idx[None, :]
    return seg.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xh: torch.Tensor, dta: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                 chunk: int):
    """The chunked SSD scan.

    xh (B, T, H, P) inputs (already dt-weighted), dta (B, T, H) dt * A
    (negative), bm and cm (B, T, N) the single-group B and C.  Returns y
    (B, T, H, P) and the final state (B, H, P, N)."""
    b, t, h, p = xh.shape
    n = bm.shape[-1]
    t0 = t
    pad = (-t) % chunk
    if pad:  # zero-dt padding is a no-op on the recurrence (exp(0) = 1, dB x = 0)
        zf = lambda v: F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
        xh, dta, bm, cm = zf(xh), zf(dta), zf(bm), zf(cm)
        t = t + pad
    c = t // chunk
    x_ = xh.reshape(b, c, chunk, h, p)
    a_ = dta.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (B, H, C, L)
    b_ = bm.reshape(b, c, chunk, n)
    c__ = cm.reshape(b, c, chunk, n)

    a_cum = torch.cumsum(a_, dim=-1)  # (B, H, C, L)
    # 1. the intra-chunk (quadratic, attention-like) term: C . B^T, times
    # the decay mask, by x
    ll = torch.exp(_segsum(a_))  # (B, H, C, L, L)
    cb = torch.einsum("bcln,bcsn->bcls", c__, b_)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * ll, x_)
    # 2. each chunk's final state: x scaled by its decay to the chunk end, by B
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, H, C, L)
    xd = x_ * decay_states.permute(0, 2, 3, 1)[..., None]  # (B, C, L, H, P)
    states = torch.einsum("bcln,bclhp->bchpn", b_, xd)
    # 3. the inter-chunk recurrence over the chunk axis
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)  # (B, C+1, H, P, N)
    a_last = F.pad(a_cum[..., -1], (1, 0))  # (B, H, C+1)
    decay_chunk = torch.exp(_segsum(a_last))  # (B, H, C+1, C+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]
    # 4. the states' contribution to the output: C . state, times the decay
    out_decay = torch.exp(a_cum)  # (B, H, C, L)
    y_off = (torch.einsum("bcln,bchpn->bclhp", c__, states)
             * out_decay.permute(0, 2, 3, 1)[..., None])
    y = (y_diag + y_off).reshape(b, t, h, p)[:, :t0]
    return y, final


def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time.  u (B, T, C), w (K, C); the taps
    add in the reference's order."""
    k, t = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + t, :] * w[i]
    return out + bias


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig, di=None):
    """z | x|B|C | dt of a projection (``di``: the x and z width it holds)."""
    di, n = cfg.d_inner if di is None else di, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _rank_share(p: dict, cfg: ModelConfig, d: int) -> dict:
    """The block's weights as the rank uses them: whole outside an in-pod
    context; in-pod, the channels and entries of its heads, and ``cols``:
    its heads' columns of the whole projection (see the module
    docstring)."""
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h0, hl = model_heads(h)
    w = {"in_proj": fsdp(p["in_proj"], 0, d), "cols": None,
         "conv_w": model_whole(p["conv_w"], 1, _conv_channels(cfg)),
         "out_proj": fsdp(p["out_proj"], 1, d)}
    w.update((k, tp_enter(p[k])) for k in ("conv_b", "a_log", "dt_bias", "d_skip", "gate_norm"))
    if hl == h:
        return w
    dev = p["a_log"].device
    mine = torch.arange(h0 * ph, (h0 + hl) * ph, device=dev)  # the rank's z or x columns
    bc = torch.arange(di, di + 2 * n, device=dev)  # B and C among the conv channels
    channels = torch.cat([mine, bc])
    w["cols"] = torch.cat([mine, di + channels,
                           2 * di + 2 * n + torch.arange(h0, h0 + hl, device=dev)])
    w["conv_w"] = w["conv_w"].index_select(1, channels)
    w["conv_b"] = w["conv_b"].index_select(0, channels)
    w["gate_norm"] = w["gate_norm"].narrow(0, h0 * ph, hl * ph)
    for k in ("a_log", "dt_bias", "d_skip"):
        w[k] = w[k].narrow(0, h0, hl)
    return w


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` over the whole ``d_inner`` (in-pod: the
    rank's heads' sum of squares summed over ``model``)."""
    v = y * F.silu(z)
    if current_inpod() is None:
        return rms_norm(v, scale, cfg.norm_eps)
    vf = v.float()
    var = model_sum(torch.sum(vf * vf, dim=-1, keepdim=True)) / cfg.d_inner
    return (vf * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(v.dtype)


def _mamba_seq(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The full-sequence block: (out (B, T, D), the pre-conv x|B|C, the final
    SSD state)."""
    b, t, d = x.shape
    n = cfg.ssm_state
    w = _rank_share(p, cfg, d)
    h = w["a_log"].shape[0]  # the heads this rank runs
    di = h * cfg.ssm_head_dim
    # the projection onto the columns the rank holds, gathered whole over
    # ``model`` (column-parallel), then its heads' columns
    zxbcdt = model_whole(tp_enter(x) @ w["in_proj"], -1, 2 * cfg.d_inner + 2 * n + cfg.ssm_heads)
    if w["cols"] is not None:
        zxbcdt = zxbcdt.index_select(-1, w["cols"])
    z, xbc_pre, dt = _split_proj(zxbcdt, cfg, di)
    xbc = F.silu(_causal_conv(xbc_pre, w["conv_w"], w["conv_b"]))
    xs, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + w["dt_bias"])  # (B, T, H)
    a = -torch.exp(w["a_log"])  # (H,)
    xh = cs(xs.reshape(b, t, h, cfg.ssm_head_dim), "batch", "seq", "heads", None)
    y, final = _ssd_chunked((xh * dt[..., None]).float(), dt * a, bm.float(), cm.float(),
                            cfg.ssm_chunk)
    y = y + xh.float() * w["d_skip"][None, None, :, None]
    y = y.reshape(b, t, di).to(x.dtype)
    y = _gated_norm(y, z, w["gate_norm"], cfg)
    return cs(y @ w["out_proj"], "batch", "seq", "dmodel", reduce="model"), xbc_pre, final


def apply_mamba_train(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _mamba_seq(p, x, cfg)[0]


def apply_mamba_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The train-path forward that also returns the decode cache (the conv
    window of the last K-1 pre-conv inputs and the final SSD state), so
    serving goes on from position T."""
    out, xbc_pre, final = _mamba_seq(p, x, cfg)
    return out, {"conv": xbc_pre[:, -(cfg.ssm_conv_kernel - 1):, :], "ssm": final}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, layers: int, device) -> dict:
    """Zeros: ``conv`` (layers, B, K-1, C_conv) in ``dtype``, ``ssm`` (layers,
    B, H, P, N) fp32."""
    return {
        "conv": torch.zeros((layers, batch, cfg.ssm_conv_kernel - 1, _conv_channels(cfg)),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def apply_mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """x (B, 1, D); the exact one-step recurrence.  Returns (y (B, 1, D),
    the new ``{"conv", "ssm"}``); ``cache`` is left as it was."""
    b = x.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x[:, 0] @ p["in_proj"]  # (B, proj)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B, K, C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])
    xs, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    da = torch.exp(dt * -torch.exp(p["a_log"]))  # (B, H)
    xh = xs.reshape(b, h, cfg.ssm_head_dim).float()
    ssm = (cache["ssm"] * da[:, :, None, None]
           + (xh * dt[:, :, None])[..., None] * bm.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", ssm, cm.float())
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None, :], {"conv": window[:, 1:], "ssm": ssm}

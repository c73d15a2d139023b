"""Mixture-of-experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``).

Tokens are replicated k times, sorted by their assigned expert, ranked
within their expert's group and written into an (E, C, D) buffer with
capacity C = int(T k / E * cf + 1); the expert products are three dense
(E, C, *) batched GEMMs.  A token past its expert's capacity goes to a
trash slot and its share of the combine is lost (the reference's
capacity-factor semantics).  The router is an fp32 softmax over E, then
top-k, renormalised; an optional shared expert (DeepSeek) is a dense MLP
on every token.

Three places where a port could part from the reference, and what this
one does:

  * ``jax.lax.top_k`` lets the lower index win a tie; ``torch.topk``
    promises no order, so the top k are the first k of a stable
    descending sort.
  * The dispatch order is ``jnp.argsort``'s, which is stable:
    ``torch.argsort(stable=True)``.  Which pairs pass the capacity depends
    on it.
  * The reference combines with a scatter-add into zeros, in the model
    dtype, which on its CPU backend adds a token's k contributions in the
    sorted (ascending expert) order.  The port gathers each token's k
    contributions in that order and adds them one after another: the same
    sums, and no atomics on the card (a replayed step is bit-identical).

On an in-pod mesh every rank dispatches the pod's pairs with the pod's
capacity and runs its share of the experts (:func:`apply_moe`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch import prng
from repro_torch.models.common import apply_mlp, dense_init, dtype_of, init_mlp
from repro_torch.models.sharding import (
    all_gather,
    cs,
    current_inpod,
    fsdp,
    own_experts,
    tp_enter,
)


def init_moe(key: torch.Tensor, cfg: ModelConfig) -> dict:
    """MoE weights (stacked like ``key``), keys in sorted order: the
    ``experts``' (E, D, F) / (E, F, D) stacks, the fp32 ``router`` (D, E)
    and the optional ``shared`` expert; ``split(key, 5)`` into router, wi,
    wg, wo and shared."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = dtype_of(cfg)
    ks = prng.split(key, 5).unbind(-2)
    p = {
        "experts": {
            "wg": dense_init(ks[2], (e, d, f), dt, d),
            "wi": dense_init(ks[1], (e, d, f), dt, d),
            "wo": dense_init(ks[3], (e, f, d), dt, f),
        },
        "router": dense_init(ks[0], (d, e), torch.float32, d),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(ks[4], d, cfg.n_shared_experts * (cfg.shared_d_ff or f), dt)
    return p


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert: the reference's ``int(T k / E * cf + 1)``."""
    return int((tokens * cfg.n_experts_per_tok) / cfg.n_experts * cfg.capacity_factor + 1)


def route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """(top-k weights renormalised, top-k expert ids), each (T, k): fp32
    softmax over the experts, the lower expert id first on a tie."""
    k = cfg.n_experts_per_tok
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :k], idx[:, :k]
    return topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9), topi


def dispatch(topi: torch.Tensor, cap: int, n_experts: int):
    """The sort-based dispatch of (T, k) expert ids: (``order``, the sorted
    (token, choice) pairs' expert ids ``se`` and tokens ``st``, ``dest``: each
    sorted pair's buffer slot, ``E * cap`` for a dropped pair)."""
    t, k = topi.shape
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")  # the k copies of token i sit at i*k..
    counts = torch.bincount(se, minlength=n_experts)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=topi.device) - start[se]
    dest = torch.where(pos < cap, se * cap + pos, torch.full_like(se, n_experts * cap))
    return order, se, st, dest


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): route, dispatch, the expert GEMMs, the
    weighted combine (+ the shared expert).

    In-pod, the reference's global program over the pod's tokens (the
    baseline's over the whole batch's: the in-pod context's
    ``dispatch_axes``).  Each rank routes its own tokens; the expert ids
    are gathered over those axes, so every rank sorts the pod's (token,
    choice) pairs in the reference's order with the reference's capacity
    of the pod's T tokens: the same pairs are kept or dropped.  The rank
    runs its ``E / model`` experts on its own tokens' pairs: within an
    expert those sit side by side in the sorted order, so its buffer holds,
    an expert, as many slots as the most its tokens keep in one of its
    experts (outside the mesh: the capacity).  ``experts/wi|wg`` are split
    over ``model`` by expert; ``experts/wo`` falls under the reference's
    ``wo$`` rule, split over its ff rows, and the rank's experts' rows come
    from the other ``model`` ranks (:func:`own_experts`).  The rank
    combines for its own tokens and sums the experts' contributions over
    ``model``.  A token's k contributions land on their experts' ranks, so
    the sum over ``model`` adds them in another order than the reference's
    scatter-add: the same to the last bit at k = 2 in fp32.  The router and
    the tokens enter the tensor-parallel region (``tp_enter``): the combine
    weights' gradient is each rank's experts'."""
    ip = current_inpod()
    b, s, d = x.shape
    t, k, e = b * s, cfg.n_experts_per_tok, cfg.n_experts
    xt = tp_enter(x).reshape(t, d)
    topw, topi = route({"router": tp_enter(fsdp(p["router"], 0, d))}, xt, cfg)
    index, el, m = 0, e, 0  # this rank's token shard, its experts' count and first
    if ip is not None:
        for axis in ip.dispatch_axes:
            index = index * ip.sizes[axis] + ip.coords[axis]
        for axis in reversed(ip.dispatch_axes):  # the minor axis first: the batch's order
            if ip.sizes[axis] > 1:
                topi = all_gather(topi, ip.group(axis)).reshape(-1, k)
        el, m = e // ip.sizes["model"], ip.coords["model"] * (e // ip.sizes["model"])
    cap = capacity(topi.shape[0], cfg)
    order, se, st, dest = dispatch(topi, cap, e)
    first = index * t
    # the sorted pairs of this rank's tokens, each token's k in ascending
    # expert order; their place in their expert's group (>= cap: dropped)
    pairs = torch.argsort(st, stable=True).reshape(-1, k)[first:first + t]
    ids = se[pairs]
    pos = dest[pairs] - ids * cap
    mine = (pos < cap) & (ids >= m) & (ids < m + el)
    slots = cap
    if ip is not None:  # from the first slot this rank's tokens take in the expert
        pos = pos - torch.bincount(topi[:first].reshape(-1), minlength=e)[ids]
        slots = int(torch.amax(torch.where(mine, pos + 1, 0))) if t else 0
    # a pair of another rank's expert (or dropped) -> the trash slot
    slot = torch.where(mine, (ids - m) * slots + pos, el * slots)
    rows = xt[:, None].expand(t, k, d).reshape(t * k, d)
    buf = xt.new_zeros((el * slots + 1, d)).index_put((slot.reshape(-1),), rows)
    h = cs(buf[: el * slots].reshape(el, slots, d), "experts", None, None)
    ex = p["experts"]
    act = torch.matmul(h, fsdp(ex["wi"], 1, d)) * F.silu(torch.matmul(h, fsdp(ex["wg"], 1, d)))
    act = cs(act, "experts", None, None)
    out = torch.matmul(act, fsdp(own_experts(ex["wo"]), 2, d))
    out_buf = torch.cat([out.reshape(el * slots, d), out.new_zeros((1, d))], dim=0)
    sw = topw.reshape(-1).to(x.dtype)[order[pairs] - first * k]  # (t, k)
    # each token's k contributions in sorted (ascending expert) order, added
    # one after another from zero: the reference's scatter-add sums
    contrib = out_buf[slot] * sw[..., None]
    y = torch.zeros_like(contrib[:, 0])
    for j in range(k):
        y = y + contrib[:, j]
    y = cs(y, reduce="model")
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x).reshape(t, d)
    return cs(y.reshape(b, s, d), "batch", "seq", "dmodel")

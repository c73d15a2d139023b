"""Backward-interleaved gradient segments (port of ``repro.models.segment_tap``).

The engine's default streamed producer (``CohortEngine._grad_segments``)
materializes the whole batched gradient tree before the first layout segment
reaches the encoder: the client pass holds every gradient leaf plus the
encoder state.  Reverse-mode AD makes the cotangents layer by layer, last
layer first, and this module taps that order:

  * every registry ``train_loss`` is a composition of **stage functions** --
    ``embed_stage -> stack_stage* -> head_stage`` -- with signature
    ``(params subtree, carry, ctx) -> carry'`` (see the family modules);
  * :class:`InterleavedSegments` replays those stages: one forward sweep
    under ``torch.no_grad()`` keeps the carry into each stage, then the
    backward sweep walks the stages in reverse, recomputing each stage's
    forward on detached leaf copies of its subtree and taking one
    ``torch.autograd.grad`` a stage.  A static **plan** maps stage
    gradients onto layout-segment slots (a stacked layer chunk -> its
    sliced segment; the tied embedding -> the SUM of the embed and head
    stages' contributions), and a segment is yielded as soon as its last
    contribution arrives -- backward order, which the engine's
    ``grad_segments_fn`` contract accepts.  The encode of stage k's
    segments is queued on the device while stage k-1's backward runs; the
    full gradient tree never exists.
  * each boundary carry is dropped right after its stage's backward, so
    the live set at any instant is the remaining boundary activations, one
    stage's gradients, the pending cross-stage accumulators (the tied
    embedding) and the encoder's buffers.  :meth:`peak_live_grad_bytes`
    is the reference's bound on that set.

The cohort's clients go one at a time inside each stage, in client order,
and their gradients stack into ``(C, ...)``: the reference vmaps each
stage's VJP over the cohort, but the layers run under
``torch.utils.checkpoint``, which ``torch.func`` does not transform.

**Bit-identity contract.** The wire produced through this producer is
bit-identical to the one-pass encode of the gradients it computes
(:meth:`grads_fn`: the same stage gradients, the tree materialized and then
sliced by the layout): every segment's blocks are assembled from the same
piece tensors in both paths, and concatenation, cast and padding are
value-exact.  The staged gradients are not bitwise those of one
``torch.autograd.grad`` of the whole loss, so equivalence to the engine's
default path is held at allclose.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import GradientLayout, _leaf_size, assemble, flatten_tree

__all__ = [
    "Stage",
    "build_stages",
    "interleaved_layout",
    "InterleavedSegments",
]


@dataclasses.dataclass(frozen=True)
class Stage:
    """One link of the staged train loss.

    ``select(params)`` picks the parameter subtree this stage's forward
    reads; ``fwd(sp, carry, ctx)`` advances the activation carry (``carry``
    is ignored when ``has_carry`` is False -- the embed stage).  ``ranges``
    aligns ``tree.leaves(select(params))`` with the FULL parameter tree:
    entry i says stage-gradient leaf i is the flat scalar span ``[lo, hi)``
    of the full-tree leaf named ``name`` (keystr path).  A layer-chunk
    stage's spans cover only its chunk's rows; shared leaves (the tied
    embedding) appear in several stages' ranges with identical spans and
    their gradients SUM.
    """

    name: str
    select: Callable[[Any], Any]
    fwd: Callable[[Any, Any, Dict[str, Any]], Any]
    ranges: Tuple[Tuple[str, int, int], ...]
    has_carry: bool = True


def _chunk_bounds(n_layers: int, chunks: int) -> List[Tuple[int, int]]:
    """Near-even [lo, hi) partition of the stacked layer axis."""
    chunks = max(1, min(int(chunks), n_layers))
    base, rem = divmod(n_layers, chunks)
    bounds, lo = [], 0
    for i in range(chunks):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _abstract_params(cfg: ModelConfig):
    """The parameter tree on the meta device: geometry, nothing allocated."""
    from repro_torch.models import model as model_api

    return model_api.init_params(cfg, 0, "meta")


def _subtree_ranges(
    subtree: Any,
    rename: Callable[[str], str],
    lo_hi: Optional[Tuple[int, int]] = None,
) -> Tuple[Tuple[str, int, int], ...]:
    """Ranges aligned with ``tree.leaves(subtree)``.  With ``lo_hi`` the
    subtree is the FULL stacked tree and each leaf's span is its
    ``[lo, hi)`` axis-0 slice."""
    out = []
    for path, leaf in tree_util.leaves(subtree):
        name = rename(tree_util.keystr(path))
        size = _leaf_size(leaf.shape)
        if lo_hi is None:
            out.append((name, 0, size))
        else:
            lo, hi = lo_hi
            stride = size // leaf.shape[0]
            out.append((name, lo * stride, hi * stride))
    return tuple(out)


def _stack_chunk_stages(
    aparams_stack: Any,
    key: str,
    fwd_of_chunk: Callable[..., Any],
    layer_chunks: int,
) -> List[Stage]:
    """Per-chunk stages over one stacked (L, ...) parameter subtree."""
    n_layers = tree_util.leaves(aparams_stack)[0][1].shape[0]
    stages = []
    for lo, hi in _chunk_bounds(n_layers, layer_chunks):
        stages.append(
            Stage(
                name=f"{key}[{lo}:{hi}]",
                select=lambda p, lo=lo, hi=hi: tree_util.tree_map(lambda v: v[lo:hi], p[key]),
                fwd=fwd_of_chunk,
                ranges=_subtree_ranges(aparams_stack, lambda s: f"['{key}']" + s, (lo, hi)),
            )
        )
    return stages


def _embed_stage(embed_stage, cfg: ModelConfig, embed_size: int) -> Stage:
    return Stage(
        name="embed",
        select=lambda p: {"embed": p["tok"]["embed"]},
        fwd=lambda sp, x, ctx: embed_stage(sp, ctx, cfg),
        ranges=(("['tok']['embed']", 0, embed_size),),
        has_carry=False,
    )


def _head_stage(select, head, cfg: ModelConfig, aparams: Any) -> Stage:
    return Stage(
        name="head",
        select=select,
        fwd=lambda sp, x, ctx: head(sp, x, ctx, cfg),
        ranges=_subtree_ranges(select(aparams), lambda s: s),
    )


def build_stages(
    cfg: ModelConfig, aparams: Any, layer_chunks: int = 1
) -> Tuple[List[Stage], Callable[[Any, ModelConfig], Dict[str, Any]]]:
    """(forward-order stages, train_ctx fn) for one registry family.

    ``layer_chunks`` splits the main stacked run into that many stages so
    gradients stream out mid-stack; the hybrid family's weight-shared
    attention block ties every group together, so its stack is always ONE
    stage (chunking would re-associate the shared block's gradient sum and
    break bit-identity with train_loss).
    """
    fam = cfg.family
    embed_size = _leaf_size(aparams["tok"]["embed"].shape)
    if fam in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as tf

        stages = [_embed_stage(tf.embed_stage, cfg, embed_size)]
        if "layers_dense" in aparams:
            stages.append(
                Stage(
                    name="layers_dense",
                    select=lambda p: p["layers_dense"],
                    fwd=lambda sp, x, ctx: tf.stack_stage(sp, x, ctx, cfg, moe=False),
                    ranges=_subtree_ranges(aparams["layers_dense"],
                                           lambda s: "['layers_dense']" + s),
                )
            )
        stages += _stack_chunk_stages(
            aparams["layers"], "layers",
            lambda sp, x, ctx: tf.stack_stage(sp, x, ctx, cfg, moe=cfg.is_moe),
            layer_chunks,
        )
        stages.append(_head_stage(lambda p: tf.head_params(p, cfg), tf.head_stage, cfg,
                                  aparams))
        return stages, tf.train_ctx
    if fam == "ssm":
        from repro_torch.models import ssm_lm as sm
        from repro_torch.models.common import head_loss, head_loss_params

        stages = [_embed_stage(sm.embed_stage, cfg, embed_size)]
        stages += _stack_chunk_stages(
            aparams["layers"], "layers",
            lambda sp, x, ctx: sm.stack_stage(sp, x, ctx, cfg), layer_chunks,
        )
        stages.append(_head_stage(lambda p: head_loss_params(p, cfg), head_loss, cfg, aparams))
        return stages, sm.train_ctx
    if fam == "hybrid":
        if layer_chunks > 1:
            raise ValueError(
                "hybrid stacks cannot be chunked: the weight-shared attention "
                "block ties every group, so chunking would re-associate its "
                "gradient sum (layer_chunks must be 1)"
            )
        from repro_torch.models import hybrid as hy
        from repro_torch.models.common import head_loss, head_loss_params

        stages = [
            _embed_stage(hy.embed_stage, cfg, embed_size),
            Stage(
                name="stack",
                select=lambda p: {"mamba_layers": p["mamba_layers"], "shared": p["shared"]},
                fwd=lambda sp, x, ctx: hy.stack_stage(sp, x, ctx, cfg),
                ranges=_subtree_ranges(
                    {"mamba_layers": aparams["mamba_layers"], "shared": aparams["shared"]},
                    lambda s: s,
                ),
            ),
            _head_stage(lambda p: head_loss_params(p, cfg), head_loss, cfg, aparams),
        ]
        return stages, hy.train_ctx
    raise NotImplementedError(
        f"no interleaved stage decomposition for family {fam!r} "
        "(the encoder-decoder audio family has no staged train loss)"
    )


def interleaved_layout(
    cfg: ModelConfig,
    n: int,
    layer_chunks: int = 1,
    row_multiple: int = 1,
    s_ratio: Optional[Callable[[str, Tuple[int, ...]], Optional[float]]] = None,
    group_scalars: int = 0,
) -> GradientLayout:
    """Per-tensor layout whose stacked-layer leaves are split at the
    producer's chunk boundaries, so every chunk stage completes whole
    segments (an unsplit (L, ...) leaf's single segment would only finish
    when the LAST chunk backprops, killing the interleave)."""
    aparams = _abstract_params(cfg)
    bounds: List[Tuple[int, int]] = []
    if layer_chunks > 1 and cfg.family in ("dense", "moe", "vlm", "ssm"):
        n_layers = tree_util.leaves(aparams["layers"])[0][1].shape[0]
        bounds = _chunk_bounds(n_layers, layer_chunks)
    parts = [hi - lo for lo, hi in bounds]

    def split(name: str, shape: Tuple[int, ...]):
        # every leaf under the main stack ("['layers']['attn']['wq']", ...);
        # "['layers_dense']..." does not share the prefix
        if name.startswith("['layers']"):
            return parts
        return None

    keys, leaves = flatten_tree(aparams)
    shapes = tuple((tuple(l.shape), l.dtype) for l in leaves)
    names = [tree_util.keystr(p) for p, _ in tree_util.leaves(aparams)]
    return GradientLayout.from_shapes_per_tensor(
        keys, shapes, n, row_multiple=row_multiple, names=names,
        s_ratio=s_ratio, group_scalars=group_scalars,
        split=split if parts else None,
    )


# ---------------------------------------------------------------------------
# The producer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Contrib:
    """One stage-gradient fragment -> segment-slot destination."""

    gleaf: int  # index into tree.leaves(stage gradients)
    a: int  # slice [a, b) within the stage leaf's flat span
    b: int
    seg: int  # destination segment index
    slot: int  # position within the segment (leaf slot j)
    dst: int  # offset within the slot


class InterleavedSegments:
    """``grad_segments_fn`` that yields layout segments in backward order.

    Engine hook signature: ``producer(params, batch, layout)`` yields
    ``(segment index, (C, rows, N) blocks)`` for the ``(C, ...)`` cohort
    batch, on the parameters' device.  ``grads_fn(params, batch)``
    materializes the matching batched gradient TREE from the same stage
    gradients -- the one-pass reference the wire bit-identity checks hold
    it to.  Construct via
    :func:`repro_torch.fed.engine.make_interleaved_segments`.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        layout: GradientLayout,
        grad_accum: int = 1,
        layer_chunks: int = 1,
    ):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if grad_accum > 1 and cfg.family == "vlm":
            raise ValueError(
                "grad_accum microbatching splits the per-client sample axis, "
                "which the VLM batch's positions tensor does not carry "
                "(use grad_accum=1)"
            )
        self.cfg = cfg
        self.layout = layout
        self.grad_accum = int(grad_accum)
        self._aparams = _abstract_params(cfg)
        self.stages, self._ctx_fn = build_stages(cfg, self._aparams, layer_chunks)
        self._check_layout(layout)
        self._build_plan()

    # -- construction --------------------------------------------------------

    def _check_layout(self, layout: GradientLayout) -> None:
        items = tree_util.leaves(self._aparams)
        self._leaf_names = [tree_util.keystr(p) for p, _ in items]
        want = tuple(tuple(leaf.shape) for _, leaf in items)
        got = tuple(s for s, _ in layout.shapes)
        if want != got or tuple(layout.treedef) != flatten_tree(self._aparams)[0]:
            raise ValueError(
                f"layout does not describe {self.cfg.name!r}'s parameter tree "
                "(build it with interleaved_layout / GradientLayout.per_tensor "
                "over the model params)"
            )

    def _build_plan(self) -> None:
        """Static fold plan: stage-gradient fragments -> segment slots.

        Per slot, contributions with IDENTICAL spans sum (shared leaves: the
        tied embedding accumulates embed + head stage gradients, in backward
        arrival order -- the same order :meth:`grads_fn` uses, so both paths
        add the same tensors in the same order); DISJOINT spans concatenate
        by offset (a split leaf's chunks).  Anything else is a plan bug and
        raises here, as does an uncovered slot (a leaf no stage produces).
        """
        name2id = {n: i for i, n in enumerate(self._leaf_names)}
        slots_by_leaf: Dict[int, List[Tuple[int, int, int, int]]] = {}
        for seg in self.layout.segments:
            for j, (lid, size, off) in enumerate(zip(seg.leaf_ids, seg.sizes, seg.leaf_offsets)):
                slots_by_leaf.setdefault(lid, []).append((seg.index, j, off, off + size))
        self._stage_contribs: List[List[_Contrib]] = []
        self._stage_scalars: List[int] = []
        spans: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for st in self.stages:
            contribs = []
            for gi, (nm, lo, hi) in enumerate(st.ranges):
                if nm not in name2id:
                    raise ValueError(
                        f"stage {st.name!r} produces unknown leaf {nm} "
                        "(stage protocol drifted from the parameter tree)"
                    )
                for sidx, j, slo, shi in slots_by_leaf[name2id[nm]]:
                    ov_lo, ov_hi = max(lo, slo), min(hi, shi)
                    if ov_lo < ov_hi:
                        contribs.append(_Contrib(gi, ov_lo - lo, ov_hi - lo, sidx, j, ov_lo - slo))
                        spans.setdefault((sidx, j), []).append((ov_lo - slo, ov_hi - ov_lo))
            self._stage_contribs.append(contribs)
            self._stage_scalars.append(sum(hi - lo for _, lo, hi in st.ranges))
        self._pending = [0] * len(self.layout.segments)
        for contribs in self._stage_contribs:
            for cb in contribs:
                self._pending[cb.seg] += 1
        # validate: every slot exactly tiled (identical spans = sums, fine)
        for seg in self.layout.segments:
            for j, size in enumerate(seg.sizes):
                sl = spans.get((seg.index, j))
                if not sl:
                    raise ValueError(
                        f"segment {seg.name!r} slot {j} (leaf "
                        f"{self._leaf_names[seg.leaf_ids[j]]}) is produced by no stage"
                    )
                cursor = 0
                for dst, ln in sorted(set(sl)):
                    if dst != cursor:
                        raise ValueError(
                            f"segment {seg.name!r} slot {j}: stage spans "
                            f"overlap or leave a gap at offset {cursor}"
                        )
                    cursor += ln
                if cursor != size:
                    raise ValueError(
                        f"segment {seg.name!r} slot {j}: stages cover {cursor} of {size} scalars"
                    )
        # emit order within a segment = flat scalar order (slot, then offset)
        self._seg_piece_keys: List[List[Tuple[int, int]]] = []
        self._seg_piece_info: List[List[Tuple[int, int]]] = []
        for seg in self.layout.segments:
            keys = sorted({
                (cb.slot, cb.dst)
                for contribs in self._stage_contribs
                for cb in contribs
                if cb.seg == seg.index
            })
            self._seg_piece_keys.append(keys)
            self._seg_piece_info.append([
                (seg.leaf_ids[slot], seg.leaf_offsets[slot] + dst) for slot, dst in keys
            ])

    def _assemble(self, seg_index: int, pieces: List[torch.Tensor]) -> torch.Tensor:
        """Pieces -> (C, rows, N) blocks for one segment, matching
        ``GradientLayout._segment_flat`` value-exactly (the pieces in flat
        order in one f32 buffer, zero-padded, reshaped)."""
        seg = self.layout.segments[seg_index]
        c = pieces[0].shape[0]
        if len(pieces) == 1 and not seg.pad:
            flat = pieces[0].to(torch.float32)
        else:
            flat = torch.zeros((c, seg.size + seg.pad), dtype=torch.float32,
                               device=pieces[0].device)
            pos = 0
            for p in pieces:
                flat[:, pos:pos + p.shape[1]] = p
                pos += p.shape[1]
        return flat.reshape(c, seg.rows, self.layout.n)

    # -- the backward sweep --------------------------------------------------

    def _microbatches(self, batch: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        acc = self.grad_accum
        if acc == 1:
            return [batch]
        bsz = tree_util.leaves(batch)[0][1].shape[1]
        if bsz % acc:
            raise ValueError(f"grad_accum={acc} must divide the per-client batch size {bsz}")
        mb = bsz // acc
        return [{k: v.narrow(1, m * mb, mb) for k, v in batch.items()} for m in range(acc)]

    def _stage_vjp(self, k: int, sp: Any, x, ct, ctx) -> Tuple[List[torch.Tensor], Any]:
        """Stage ``k``'s forward recomputed on detached leaf copies of its
        subtree ``sp`` (and of the carry ``x``), then one autograd pass with
        the output cotangent ``ct`` (None: ones, the loss's own): (its
        parameter gradients in ``tree.leaves`` order, the carry's cotangent
        or None).  A leaf the stage does not reach gets zeros, as the
        reference's VJP gives."""
        st = self.stages[k]
        items = tree_util.leaves(sp)
        leaves = [v.detach().requires_grad_(True) for _, v in items]
        sp_g = tree_util.unflatten(zip((path for path, _ in items), leaves))
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True) if st.has_carry else None
            out = st.fwd(sp_g, xg, ctx)
            grads = torch.autograd.grad(out, leaves + ([xg] if st.has_carry else []),
                                        grad_outputs=torch.ones_like(out) if ct is None else ct,
                                        allow_unused=True)
        gp = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]
        return gp, (grads[-1] if st.has_carry else None)

    def _run(self, params: Any, batch: Dict[str, torch.Tensor]) -> Iterator[
            Tuple[int, List[torch.Tensor]]]:
        """Yields ``(segment index, pieces)`` in backward completion order;
        ``pieces`` aligns with ``self._seg_piece_info[segment index]``."""
        stages = self.stages
        ns = len(stages)
        sel = [st.select(params) for st in stages]
        batches = self._microbatches(batch)
        acc = len(batches)
        c = tree_util.leaves(batch)[0][1].shape[0]
        # per microbatch m and client i: its batch's stage context
        ctxs = [[self._ctx_fn({k: v[i] for k, v in b.items()}, self.cfg) for i in range(c)]
                for b in batches]
        # forward: keep the carry INTO each stage (the last stage's output --
        # the loss -- is never needed for its own backward)
        carries: List[Optional[List[List[Any]]]] = [
            [[None] * c for _ in range(acc)] for _ in range(ns)]
        with torch.no_grad():
            for m in range(acc):
                for i in range(c):
                    x = None
                    for k in range(ns - 1):
                        carries[k][m][i] = x
                        x = stages[k].fwd(sel[k], x, ctxs[m][i])
                    carries[ns - 1][m][i] = x
                    del x
        cts = [[None] * c for _ in range(acc)]
        pending = list(self._pending)
        accbuf: Dict[Tuple[int, int, int], torch.Tensor] = {}
        for k in reversed(range(ns)):
            # the cohort's stage gradients, client by client into (C, ...)
            g: List[Optional[torch.Tensor]] = []
            for i in range(c):
                gsum = None
                for m in range(acc):
                    gm, cts[m][i] = self._stage_vjp(k, sel[k], carries[k][m][i], cts[m][i],
                                                    ctxs[m][i])
                    # summed in the leaf's dtype, in microbatch order
                    gsum = gm if gsum is None else [a + b for a, b in zip(gsum, gm)]
                    del gm
                if acc > 1:
                    gsum = [v / acc for v in gsum]
                if not g:
                    g = [v.new_empty((c,) + tuple(v.shape)) for v in gsum]
                for out, v in zip(g, gsum):
                    out[i] = v
                del gsum
            carries[k] = None  # boundary activations freed as we walk back
            flats = [v.reshape(c, -1) for v in g]
            del g
            for cb in self._stage_contribs[k]:
                flat = flats[cb.gleaf]
                piece = flat if cb.a == 0 and cb.b == flat.shape[1] else flat[:, cb.a:cb.b]
                key = (cb.seg, cb.slot, cb.dst)
                prev = accbuf.get(key)
                # identical spans add in arrival order, in the leaf's dtype
                accbuf[key] = piece if prev is None else prev + piece
                del prev, piece, flat
                pending[cb.seg] -= 1
                if pending[cb.seg] == 0:
                    yield cb.seg, [accbuf.pop((cb.seg,) + pk)
                                   for pk in self._seg_piece_keys[cb.seg]]
            del flats

    # -- public faces --------------------------------------------------------

    def __call__(self, params: Any, batch: Dict[str, torch.Tensor],
                 layout: GradientLayout) -> Iterator[Tuple[int, torch.Tensor]]:
        """The engine's ``grad_segments_fn`` hook: backward-ordered
        ``(segment index, (C, rows, N) blocks)``."""
        if layout is not self.layout and layout != self.layout:
            raise ValueError(
                "engine layout differs from the producer's -- pass the same "
                "GradientLayout to CohortEngine(layout=) and make_interleaved_segments"
            )
        for seg_idx, pieces in self._run(params, batch):
            blocks = self._assemble(seg_idx, pieces)
            del pieces  # the bf16 pieces need not outlive the f32 blocks
            yield seg_idx, blocks

    def grads_fn(self, params: Any, batch: Dict[str, torch.Tensor]) -> Any:
        """One-pass reference: the batched gradient TREE assembled from the
        SAME stage-gradient tensors the segment stream emits (leaf pieces
        concatenated in offset order).  Slicing this tree through the layout
        reproduces the streamed wire bit for bit -- the producer's
        correctness oracle."""
        c = tree_util.leaves(batch)[0][1].shape[0]
        by_leaf: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        for seg_idx, pieces in self._run(params, batch):
            for (lid, abs_off), arr in zip(self._seg_piece_info[seg_idx], pieces):
                by_leaf.setdefault(lid, []).append((abs_off, arr))
        leaves = []
        for lid, (shape, dtype) in enumerate(self.layout.shapes):
            plist = sorted(by_leaf.pop(lid), key=lambda t: t[0])
            flat = plist[0][1] if len(plist) == 1 else torch.cat([p for _, p in plist], dim=-1)
            leaves.append(flat.reshape((c,) + tuple(shape)).to(dtype))
        return assemble(self.layout.treedef, leaves)

    # -- accounting ----------------------------------------------------------

    @property
    def stage_names(self) -> List[str]:
        return [st.name for st in self.stages]

    def peak_live_grad_bytes(self, clients: int) -> int:
        """Analytic peak of GRADIENT + ENCODER bytes held live at once by the
        interleaved client pass (f32 scalars x clients): walks the fold plan
        backward tracking one stage's gradients plus the pending cross-stage
        accumulators, then adds a double-buffered largest-segment encode
        working set (the in-flight and the just-queued segment's encoder
        state).  Stage-boundary activations and the packed wire are not
        counted.  The reference's bound, integer for integer."""
        peak = live = 0
        pending = list(self._pending)
        buf: Dict[Tuple[int, int, int], int] = {}
        for k in reversed(range(len(self.stages))):
            for cb in self._stage_contribs[k]:
                key = (cb.seg, cb.slot, cb.dst)
                if key not in buf:
                    buf[key] = cb.b - cb.a
                    live += cb.b - cb.a
                peak = max(peak, self._stage_scalars[k] + live)
                pending[cb.seg] -= 1
                if pending[cb.seg] == 0:
                    for pk in self._seg_piece_keys[cb.seg]:
                        live -= buf.pop((cb.seg,) + pk)
            peak = max(peak, self._stage_scalars[k] + live)
        return clients * (4 * peak + 2 * self.layout.encoder_live_bytes(streamed=True))

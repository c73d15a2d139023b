"""Per-tensor gradient block geometry (port of ``repro.core.layout``).

The codec's stages -- sparsify, project, quantize -- are all defined per
block row, so the gradient need not be resident as ONE ``(nblocks, N)``
grid.  :class:`GradientLayout` owns the parameter dict <-> block-grid
geometry:

  * which leaves feed which block rows (the ownership map), the per-segment
    zero padding, and optional per-segment sparsity budgets in place of the
    config's single ``s_ratio``;
  * the **monolithic** layout (one segment: every leaf concatenated, padded
    once at the end) -- the default wire geometry everywhere;
  * the **per-tensor** layout, in which each leaf (or a group of small
    leaves, up to ``group_scalars``) gets its own independently padded run
    of block rows.  Block rows never straddle segments, so a per-tensor
    layout can be *streamed* (encode segment i, drop its blocks, go on: the
    encoder's live memory is the largest segment's, not the model's) and
    decoded segment by segment (``recon_engine.ea_decode_segments``).

Trees are dicts of tensors, flat (the paper's MLP, ``fed/toy.py``) or
nested (the model zoo's ``params["layers"]["attn"]["wq"]``).  Leaves are
ordered as ``jax.tree_util`` orders a dict tree -- keys sorted at every
level, depth first (``repro_torch.tree.leaves``) -- and named in its
``keystr`` form (``"['w1']"``, ``"['layers']['attn']['wq']"``), so block
rows, segment names, ``s_ratio`` and ``split`` arguments and the engine's
``wire_segments`` events read the same as the reference's.

All geometry -- sizes, offsets, row counts -- is Python ints, computed at
construction.  A segment whose padded span exceeds int32 raises
``ValueError`` there, naming the per-tensor layout as the fix (the
reference raises the same unless JAX's x64 switch is on; torch has no such
switch, so the port always raises).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tree_util

__all__ = [
    "LayoutSegment",
    "GradientLayout",
    "as_layout",
    "INT32_MAX",
]

INT32_MAX = 2**31 - 1

Tree = Dict[str, torch.Tensor]
Shapes = Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


def _leaf_size(shape) -> int:
    """Python-int scalar count of one leaf."""
    return math.prod(int(d) for d in shape) if shape else 1


def _check_int32(span: int, what: str) -> None:
    """Flat index math over a segment wraps past int32: raise with the fix
    named rather than corrupt silently."""
    if span <= INT32_MAX:
        return
    raise ValueError(
        f"{what} spans {span} scalars > int32 max {INT32_MAX}: flat index "
        "math would overflow.  Use a per-tensor GradientLayout (each "
        "segment then only needs its own tensor's span)."
    )


def flatten_tree(tree: Tree) -> Tuple[Tuple, List[torch.Tensor]]:
    """(treedef, leaves in ``jax.tree_util`` order) of a parameter dict.
    The treedef holds one entry a leaf: its key for a top-level leaf (a
    flat dict's treedef is its sorted key tuple), else its key path."""
    items = tree_util.leaves(tree)
    return (tuple(p[0] if len(p) == 1 else p for p, _ in items),
            [leaf for _, leaf in items])


def _path(entry) -> Tuple[str, ...]:
    """A treedef entry as a key path."""
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _keystr(entry) -> str:
    """``jax.tree_util.keystr`` of a treedef entry: ``['w1']``,
    ``['layers']['attn']['wq']``."""
    return tree_util.keystr(_path(entry))


def assemble(treedef: Sequence, leaves: Sequence) -> Tree:
    """The dict (nested where the treedef's entries are paths) holding
    ``leaves`` in treedef order -- the inverse of the flatten."""
    if all(isinstance(e, str) for e in treedef):
        return dict(zip(treedef, leaves))
    return tree_util.unflatten(zip((_path(e) for e in treedef), leaves))


@dataclasses.dataclass(frozen=True)
class LayoutSegment:
    """One independently padded run of block rows.

    ``leaf_ids`` index the layout's leaf list; the segment's scalars are
    those leaves flattened and concatenated in leaf order, zero-padded by
    ``pad`` to exactly ``rows * n``.  ``s`` is the per-block top-S budget
    the encoder applies to this segment's rows (None: the config's global
    ``s``).  ``offsets`` (None for whole-leaf segments) marks a SLICED
    segment made by the ``split`` hook: entry j says it owns leaf
    ``leaf_ids[j]``'s flat scalars ``[offsets[j], offsets[j] + sizes[j])``.
    """

    index: int
    name: str
    leaf_ids: Tuple[int, ...]
    sizes: Tuple[int, ...]  # per-leaf scalar counts
    size: int  # sum(sizes)
    rows: int  # block rows owned
    row_start: int  # first row in the layout's global block grid
    pad: int  # zero scalars appended (rows * n - size)
    s: Optional[int] = None  # per-segment top-S override (None = global)
    offsets: Optional[Tuple[int, ...]] = None  # per-leaf flat start (sliced)

    @property
    def row_slice(self) -> slice:
        return slice(self.row_start, self.row_start + self.rows)

    @property
    def leaf_offsets(self) -> Tuple[int, ...]:
        """Per-leaf flat start offsets (0s for whole-leaf segments)."""
        return self.offsets if self.offsets is not None else (0,) * len(self.leaf_ids)


@dataclasses.dataclass(frozen=True)
class GradientLayout:
    """The parameter dict <-> block-grid spec: keys, leaf shapes, segments.

    This object *is* the spec the codec, engine and API pass around
    (``blocks_to_tree`` takes it directly).  ``treedef`` lists the leaves
    in order, each by its key (top-level leaves) or key path (nested
    leaves): the port's counterpart of the reference's treedef.
    Immutable and hashable; all tensor work happens in :meth:`to_blocks`
    and :meth:`tree_from_blocks`, driven by the Python geometry.
    """

    n: int  # block size N
    row_multiple: int
    treedef: Tuple  # per leaf, in order: its key, or its key path when nested
    shapes: Shapes  # per-leaf (shape, dtype)
    segments: Tuple[LayoutSegment, ...]
    nbar: int  # total scalars across all leaves (pre-padding)
    kind: str = "monolithic"  # or "per_tensor"

    # -- construction --------------------------------------------------------

    @classmethod
    def monolithic(cls, tree: Tree, n: int, row_multiple: int = 1) -> "GradientLayout":
        """One segment covering every leaf, padded once at the end."""
        keys, leaves = flatten_tree(tree)
        shapes = tuple((tuple(l.shape), l.dtype) for l in leaves)
        return cls.from_shapes(keys, shapes, n, row_multiple=row_multiple)

    @classmethod
    def from_shapes(
        cls,
        treedef: Sequence[str],
        shapes: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
        n: int,
        row_multiple: int = 1,
    ) -> "GradientLayout":
        """Monolithic layout from abstract (shape, dtype) specs -- no tensors
        needed, so the geometry (and the int32 guard) is testable at any
        scale."""
        shapes = tuple((tuple(s), d) for s, d in shapes)
        sizes = tuple(_leaf_size(s) for s, _ in shapes)
        nbar = sum(sizes)
        rows = -(-nbar // n)
        rows = -(-rows // row_multiple) * row_multiple
        _check_int32(rows * n, "monolithic layout")
        seg = LayoutSegment(
            index=0, name="all", leaf_ids=tuple(range(len(shapes))), sizes=sizes, size=nbar,
            rows=rows, row_start=0, pad=rows * n - nbar,
        )
        return cls(n=n, row_multiple=row_multiple, treedef=tuple(treedef), shapes=shapes,
                   segments=(seg,), nbar=nbar, kind="monolithic")

    @classmethod
    def per_tensor(
        cls,
        tree: Tree,
        n: int,
        row_multiple: int = 1,
        s_ratio: Optional[Callable[[str, Tuple[int, ...]], Optional[float]]] = None,
        group_scalars: int = 0,
        split: Optional[Callable[[str, Tuple[int, ...]], Optional[Sequence[int]]]] = None,
    ) -> "GradientLayout":
        """One segment per leaf, each independently padded to the block grid.

        ``group_scalars`` > 0 coalesces consecutive small leaves into one
        segment until the group reaches that many scalars (a trailing group
        short of it rides the last one).  ``s_ratio(name, shape) -> float |
        None`` sets a per-segment sparsity budget (None: the config's
        global ``s_ratio``); a grouped segment takes its first leaf's.

        ``split(name, shape) -> [p0, p1, ...] | None`` partitions a leaf
        along axis 0 into parts of those row counts (summing to
        ``shape[0]``); each part becomes its OWN sliced segment named
        ``name[a:b]``, never coalesced with its neighbours.  ``s_ratio`` is
        asked with the leaf's name, so every part inherits its budget.
        """
        keys, leaves = flatten_tree(tree)
        shapes = tuple((tuple(l.shape), l.dtype) for l in leaves)
        return cls.from_shapes_per_tensor(
            keys, shapes, n, row_multiple=row_multiple, names=[_keystr(k) for k in keys],
            s_ratio=s_ratio, group_scalars=group_scalars, split=split,
        )

    @classmethod
    def from_shapes_per_tensor(
        cls,
        treedef: Sequence[str],
        shapes: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
        n: int,
        row_multiple: int = 1,
        names: Optional[Sequence[str]] = None,
        s_ratio: Optional[Callable[[str, Tuple[int, ...]], Optional[float]]] = None,
        group_scalars: int = 0,
        split: Optional[Callable[[str, Tuple[int, ...]], Optional[Sequence[int]]]] = None,
    ) -> "GradientLayout":
        """Abstract-spec variant of :meth:`per_tensor` (see there)."""
        shapes = tuple((tuple(s), d) for s, d in shapes)
        sizes = [_leaf_size(s) for s, _ in shapes]
        names = list(names) if names is not None else [f"leaf{i}" for i in range(len(shapes))]
        # units: (leaf id, flat offset, flat size, display name, groupable) --
        # a whole leaf (groupable), or one axis-0 slice of a split leaf
        units: List[Tuple[int, int, int, str, bool]] = []
        for i, size in enumerate(sizes):
            shape = shapes[i][0]
            parts = split(names[i], shape) if split is not None else None
            if parts is None:
                units.append((i, 0, size, names[i], True))
                continue
            parts = [int(p) for p in parts]
            if not shape or any(p <= 0 for p in parts) or sum(parts) != shape[0]:
                raise ValueError(
                    f"split for {names[i]!r} must partition axis 0 "
                    f"(shape {shape}): got parts {parts}"
                )
            stride = size // shape[0]
            lo = 0
            for p in parts:
                units.append((i, lo * stride, p * stride, f"{names[i]}[{lo}:{lo + p}]", False))
                lo += p
        # coalesce consecutive groupable units into groups >= group_scalars
        groups: List[List[Tuple[int, int, int, str, bool]]] = []
        cur: List[Tuple[int, int, int, str, bool]] = []
        cur_size = 0
        for u in units:
            if not u[4]:  # a split part: close the open group, stand alone
                if cur:
                    groups.append(cur)
                    cur, cur_size = [], 0
                groups.append([u])
                continue
            cur.append(u)
            cur_size += u[2]
            if cur_size >= max(group_scalars, 1):
                groups.append(cur)
                cur, cur_size = [], 0
        if cur:
            if groups and group_scalars > 0 and groups[-1][0][4]:
                groups[-1].extend(cur)  # a trailing stub rides the last group
            else:
                groups.append(cur)
        segments: List[LayoutSegment] = []
        row_start = 0
        for gi, ids in enumerate(groups):
            gsize = sum(u[2] for u in ids)
            rows = -(-gsize // n)
            rows = -(-rows // row_multiple) * row_multiple
            _check_int32(rows * n, f"layout segment {ids[0][3]!r}")
            s = None
            if s_ratio is not None:
                # the leaf's name, so split parts inherit the leaf's budget
                lid0 = ids[0][0]
                ratio = s_ratio(names[lid0], shapes[lid0][0])
                if ratio is not None:
                    if not (0.0 < ratio <= 1.0):
                        raise ValueError(
                            f"per-segment s_ratio for {names[lid0]!r} must be "
                            f"in (0, 1], got {ratio}"
                        )
                    s = max(1, int(ratio * n))
            sliced = any(off != 0 or sz != sizes[lid] for lid, off, sz, _, _ in ids)
            segments.append(LayoutSegment(
                index=gi,
                name=ids[0][3] if len(ids) == 1 else f"{ids[0][3]}+{len(ids) - 1}",
                leaf_ids=tuple(u[0] for u in ids),
                sizes=tuple(u[2] for u in ids),
                size=gsize,
                rows=rows,
                row_start=row_start,
                pad=rows * n - gsize,
                s=s,
                offsets=tuple(u[1] for u in ids) if sliced else None,
            ))
            row_start += rows
        return cls(n=n, row_multiple=row_multiple, treedef=tuple(treedef), shapes=shapes,
                   segments=tuple(segments), nbar=sum(sizes), kind="per_tensor")

    # -- geometry ------------------------------------------------------------

    @property
    def rows(self) -> int:
        """Total block rows across all segments (the global nb)."""
        return sum(seg.rows for seg in self.segments)

    @property
    def max_segment_rows(self) -> int:
        """Largest segment's rows -- the streamed encoder's live-memory bound."""
        return max((seg.rows for seg in self.segments), default=0)

    @property
    def spec(self) -> Tuple[Tuple[str, ...], list]:
        """The legacy ``(treedef, shapes)`` tuple this layout subsumes."""
        return (self.treedef, list(self.shapes))

    def segment_s(self, default_s: int) -> List[int]:
        """Per-segment top-S budgets with the global default filled in."""
        return [seg.s if seg.s is not None else default_s for seg in self.segments]

    def owner_map(self) -> Dict[int, Tuple[int, int, int]]:
        """leaf id -> (segment index, first row touched, last row touched + 1)
        in the GLOBAL block grid.  Exact for per-tensor layouts; in the
        monolithic layout leaves share the rows at their boundaries.  A split
        leaf spans several segments: the first one touching it is reported
        and the row range covers every piece."""
        out: Dict[int, Tuple[int, int, int]] = {}
        for seg in self.segments:
            off = 0
            for lid, size in zip(seg.leaf_ids, seg.sizes):
                r0 = seg.row_start + off // self.n
                r1 = seg.row_start + (max(off + size - 1, off)) // self.n + 1
                if lid in out:
                    p_seg, p0, p1 = out[lid]
                    out[lid] = (p_seg, min(p0, r0), max(p1, r1))
                else:
                    out[lid] = (seg.index, r0, r1)
                off += size
        return out

    def encoder_live_bytes(self, streamed: bool) -> int:
        """f32 block-domain bytes the encoder holds live at once: blocks,
        error-feedback residual in and residual out, for the whole grid
        (one-pass encode) or the largest segment (streamed encode)."""
        rows = self.max_segment_rows if streamed else self.rows
        return 3 * rows * self.n * 4

    # -- tensor ops (tree -> blocks) ------------------------------------------

    def _segment_flat(self, leaves: Sequence[torch.Tensor], seg: LayoutSegment,
                      batch: int = 0) -> torch.Tensor:
        """Flattens, concatenates and zero-pads one segment's leaves (the
        leading ``batch`` axes pass through); a sliced segment takes only its
        ``[offset, offset + size)`` span of each leaf."""
        first = leaves[seg.leaf_ids[0]]
        lead = tuple(first.shape[:batch])

        def piece(i, size, off):
            flat = leaves[i].reshape(lead + (-1,))
            return flat if off == 0 and size == flat.shape[-1] else flat.narrow(-1, off, size)

        if len(seg.leaf_ids) == 1 and not seg.pad:
            return piece(seg.leaf_ids[0], seg.sizes[0], seg.leaf_offsets[0]).to(torch.float32)
        # one f32 buffer, filled leaf by leaf: no concatenated copy beside
        # a padded one (a model's grid is GBs)
        out = torch.zeros(lead + (seg.size + seg.pad,), dtype=torch.float32, device=first.device)
        pos = 0
        for i, size, off in zip(seg.leaf_ids, seg.sizes, seg.leaf_offsets):
            out[..., pos:pos + size] = piece(i, size, off)
            pos += size
        return out

    def _leaves(self, tree: Tree) -> List[torch.Tensor]:
        return flatten_tree(tree)[1]

    def segment_blocks(self, tree: Tree, index: int) -> torch.Tensor:
        """One segment's ``(rows, N)`` block view, built from ITS leaves only
        -- the streamed encoder's unit of work."""
        seg = self.segments[index]
        return self._segment_flat(self._leaves(tree), seg).reshape(seg.rows, self.n)

    def segment_blocks_batched(self, tree: Tree, index: int) -> torch.Tensor:
        """Batched :meth:`segment_blocks`: every leaf carries a leading
        clients axis; returns ``(batch, rows, N)`` for one segment."""
        leaves = self._leaves(tree)
        seg = self.segments[index]
        batch = leaves[seg.leaf_ids[0]].shape[0]
        return self._segment_flat(leaves, seg, batch=1).reshape(batch, seg.rows, self.n)

    def iter_segment_blocks(self, tree: Tree) -> Iterator[Tuple[LayoutSegment, torch.Tensor]]:
        """Yields (segment, (rows, N) blocks) in row order."""
        leaves = self._leaves(tree)
        for seg in self.segments:
            yield seg, self._segment_flat(leaves, seg).reshape(seg.rows, self.n)

    def to_blocks(self, tree: Tree) -> torch.Tensor:
        """The full ``(rows, N)`` block grid: the segments' padded runs
        concatenated in row order (one run, padded once, when monolithic)."""
        leaves = self._leaves(tree)
        flats = [self._segment_flat(leaves, seg) for seg in self.segments]
        flat = flats[0] if len(flats) == 1 else torch.cat(flats, dim=-1)
        return flat.reshape(self.rows, self.n)

    def to_blocks_batched(self, tree: Tree) -> torch.Tensor:
        """Batched variant: every leaf carries a leading clients axis;
        returns ``(batch, rows, N)``."""
        leaves = self._leaves(tree)
        batch = leaves[0].shape[0]
        flats = [self._segment_flat(leaves, seg, batch=1) for seg in self.segments]
        flat = flats[0] if len(flats) == 1 else torch.cat(flats, dim=-1)
        return flat.reshape(batch, self.rows, self.n)

    # -- tensor ops (blocks -> tree) ------------------------------------------

    def _leaves_from_flat(self, flat: torch.Tensor, seg: LayoutSegment) -> List[torch.Tensor]:
        leaves = []
        off = 0
        for lid, size in zip(seg.leaf_ids, seg.sizes):
            shape, dtype = self.shapes[lid]
            leaves.append(flat[off : off + size].reshape(shape).to(dtype))
            off += size
        return leaves

    def _add_pieces(self, pieces: Dict[int, List[Tuple[int, torch.Tensor]]],
                    flat: torch.Tensor, seg: LayoutSegment) -> None:
        """Adds (leaf flat offset, 1-D piece) of one segment's unpadded flat
        scalars to ``pieces`` -- the inverse unit of whole-leaf and sliced
        segments alike."""
        off = 0
        for lid, size, loff in zip(seg.leaf_ids, seg.sizes, seg.leaf_offsets):
            pieces.setdefault(lid, []).append((loff, flat[off : off + size]))
            off += size

    def _assemble(self, pieces: Dict[int, List[Tuple[int, torch.Tensor]]]) -> Tree:
        """The parameter dict from (offset, flat piece) contributions: the
        pieces of a split leaf concatenate back in offset order and must
        tile it exactly."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.shapes)
        for lid, plist in pieces.items():
            shape, dtype = self.shapes[lid]
            size = _leaf_size(shape)
            plist.sort(key=lambda t: t[0])
            cursor = 0
            for off, p in plist:
                if off != cursor:
                    raise ValueError(
                        f"leaf {lid} pieces do not tile: expected offset "
                        f"{cursor}, got {off} (missing or overlapping slice)"
                    )
                cursor += int(p.shape[-1])
            if cursor != size:
                raise ValueError(f"leaf {lid} pieces cover {cursor} of {size} scalars")
            flat = plist[0][1] if len(plist) == 1 else torch.cat([p for _, p in plist], dim=-1)
            out[lid] = flat.reshape(shape).to(dtype)
        return assemble(self.treedef, out)

    def tree_from_blocks(self, blocks: torch.Tensor) -> Tree:
        """Inverse of :meth:`to_blocks` (unpad per segment, reshape leaves;
        split-leaf pieces concatenate back in offset order)."""
        pieces: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        for seg in self.segments:
            self._add_pieces(pieces, blocks[seg.row_slice].reshape(-1), seg)
        return self._assemble(pieces)

    def segment_leaves(self, index: int, seg_blocks: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Decodes ONE segment's ``(rows, N)`` blocks into its leaves (leaf id
        -> tensor) without the other segments.  A sliced segment owns leaf
        fragments, not leaves, and has no whole-leaf decode."""
        seg = self.segments[index]
        if seg.offsets is not None:
            raise ValueError(
                f"segment {seg.name!r} owns leaf slices (split layout); "
                "whole leaves only exist once every piece is present -- "
                "use tree_from_segments/tree_from_blocks"
            )
        return dict(zip(seg.leaf_ids, self._leaves_from_flat(seg_blocks.reshape(-1), seg)))

    def tree_from_segments(self, seg_blocks: Dict[int, torch.Tensor]) -> Tree:
        """The full dict from per-segment block tensors (every leaf must be
        covered; :meth:`segment_leaves` decodes a part)."""
        pieces: Dict[int, List[Tuple[int, torch.Tensor]]] = {}
        for index, blocks in seg_blocks.items():
            self._add_pieces(pieces, blocks.reshape(-1), self.segments[index])
        missing = [i for i in range(len(self.shapes)) if i not in pieces]
        if missing:
            raise ValueError(f"tree_from_segments missing leaves {missing}")
        return self._assemble(pieces)


def as_layout(spec, n: Optional[int] = None, row_multiple: int = 1) -> GradientLayout:
    """Normalizes a spec to a GradientLayout: layouts pass through; the
    legacy ``(treedef, shapes)`` tuple builds a monolithic layout (``n``
    required then)."""
    if isinstance(spec, GradientLayout):
        return spec
    treedef, shapes = spec
    if n is None:
        raise ValueError("legacy (treedef, shapes) spec needs the block size n")
    return GradientLayout.from_shapes(treedef, shapes, n, row_multiple=row_multiple)

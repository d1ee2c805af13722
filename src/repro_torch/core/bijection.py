"""Symbolic layout bijections (paper §5.2.3, Algorithm 2).

Scalify restricts reshapes to *split/merge* of axes (the paper's scope
assumption).  Under that restriction, any sequence of reshape/transpose ops
is exactly a **permutation of atomic factors**: factorize the source shape
into atoms, permute them, regroup into the destination shape.  Two layout
sequences are semantically equivalent iff their atom permutations agree
under a common refinement — this gives a sound *and* complete decision
procedure for the fragment, replacing per-element symbolic execution.

``Layout`` is therefore the canonical form of the paper's
``bijection(s1, pi, s2)`` objects, and :meth:`Layout.synthesize_ops` emits
the ``[reshape, transpose, reshape]`` repair sequence of Algorithm 2 step 4.

A reshape that re-chunks across incompatible factor boundaries (e.g.
``(2,3) -> (3,2)``) is *not* a split/merge bijection; ``then_reshape``
raises :class:`NotSplitMerge` and the verifier falls back to exact
congruence matching (sound: such graphs are simply not verified via layout
reasoning).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


class NotSplitMerge(Exception):
    """Reshape crosses atom boundaries in a non-split/merge way."""


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# interned identity layouts (one per shape — the most-constructed layout)
_IDENTITY_CACHE: dict[tuple[int, ...], "Layout"] = {}

# general intern table, populated on unpickle: the process shard backend
# ships layouts between processes, and reconstructing through this table
# dedups them on arrival (one object per distinct layout per process)
_INTERN_CACHE: dict[tuple, "Layout"] = {}


def _intern_layout(atoms, src_groups, perm, dst_groups) -> "Layout":
    key = (atoms, src_groups, perm, dst_groups)
    lay = _INTERN_CACHE.get(key)
    if lay is None:
        lay = Layout(atoms, src_groups, perm, dst_groups)
        _INTERN_CACHE[key] = lay
    return lay


# ---------------------------------------------------------------------------
# layout-composition memo: the layout_compose rule re-derives identical
# reshape/transpose applications thousands of times across a deep model's
# structurally repeated layers (~30% of the rules phase per the profiler).
# Layouts are immutable, so each (layout, op-arg) application is cached
# keyed on an interned per-process layout id — a dict probe on small int
# tuples instead of the atom-refinement walk.

_LAYOUT_IDS: dict[tuple, int] = {}
_OP_MEMO: dict[tuple, object] = {}  # (tag, layout id[, arg]) -> Layout | str
_OP_MEMO_MAX = 1 << 16  # safety valve for very long-lived processes


def _layout_id(lay: "Layout") -> int:
    """Process-local interned id over the four defining tuples (the fact-key
    id in ``repro.core.relations`` excludes ``src_groups`` — composition
    depends on the full definition, so it gets its own table)."""
    lid = lay._lid
    if lid is None:
        key = (lay.atoms, lay.src_groups, lay.perm, lay.dst_groups)
        lid = _LAYOUT_IDS.get(key)
        if lid is None:
            lid = len(_LAYOUT_IDS)
            _LAYOUT_IDS[key] = lid
        object.__setattr__(lay, "_lid", lid)
    return lid


def _op_memo(key: tuple, fn) -> "Layout":
    hit = _OP_MEMO.get(key)
    if hit is None:
        try:
            hit = fn()
        except NotSplitMerge as e:  # negative result: cache the message
            hit = str(e)
        if len(_OP_MEMO) >= _OP_MEMO_MAX:
            _OP_MEMO.clear()
        _OP_MEMO[key] = hit
    if isinstance(hit, str):
        raise NotSplitMerge(hit)
    return hit


@dataclass(frozen=True, slots=True)
class Layout:
    """A bijective layout transform ``src_shape -> dst_shape``.

    atoms:      atomic factor sizes, listed in *source* order.
    src_groups: number of consecutive atoms forming each source dim.
    perm:       ``perm[k]`` = source-atom index appearing at dst position k.
    dst_groups: number of consecutive (permuted) atoms forming each dst dim.
    """

    atoms: tuple[int, ...]
    src_groups: tuple[int, ...]
    perm: tuple[int, ...]
    dst_groups: tuple[int, ...]
    # first-use caches (slots, so named fields rather than __dict__ entries);
    # _kid is the process-local fact-key layout id assigned by
    # repro.core.relations — all four are excluded from equality, repr and
    # pickles (__reduce__ rebuilds from the four defining tuples)
    _src_shape: Optional[tuple] = field(default=None, init=False,
                                        compare=False, repr=False)
    _dst_shape: Optional[tuple] = field(default=None, init=False,
                                        compare=False, repr=False)
    _hash: Optional[int] = field(default=None, init=False, compare=False,
                                 repr=False)
    _kid: Optional[int] = field(default=None, init=False, compare=False,
                                repr=False)
    # composition-memo id (see _layout_id above): full-definition intern id,
    # distinct from _kid which drops src_groups
    _lid: Optional[int] = field(default=None, init=False, compare=False,
                                repr=False)
    _eff_ident: Optional[bool] = field(default=None, init=False,
                                       compare=False, repr=False)

    # -- derived -------------------------------------------------------------
    # src_shape/dst_shape/hash are recomputed millions of times on the rule
    # hot path; Layout is frozen, so cache them on first use.
    @property
    def src_shape(self) -> tuple[int, ...]:
        v = self._src_shape
        if v is None:
            v = self._group_shape(self.atoms, self.src_groups, range(len(self.atoms)))
            object.__setattr__(self, "_src_shape", v)
        return v

    @property
    def dst_shape(self) -> tuple[int, ...]:
        v = self._dst_shape
        if v is None:
            v = self._group_shape(self.atoms, self.dst_groups, self.perm)
            object.__setattr__(self, "_dst_shape", v)
        return v

    def __hash__(self) -> int:
        h = self._hash
        if h is None:
            h = hash((self.atoms, self.src_groups, self.perm, self.dst_groups))
            object.__setattr__(self, "_hash", h)
        return h

    def __reduce__(self):
        return (_intern_layout,
                (self.atoms, self.src_groups, self.perm, self.dst_groups))

    @staticmethod
    def _group_shape(atoms, groups, order) -> tuple[int, ...]:
        order = list(order)
        out, i = [], 0
        for g in groups:
            out.append(_prod(atoms[j] for j in order[i : i + g]))
            i += g
        return tuple(out)

    @property
    def is_identity(self) -> bool:
        return self.perm == tuple(range(len(self.atoms))) and self.dst_shape == self.src_shape

    @property
    def is_pure_regroup(self) -> bool:
        """Identity permutation (maybe different grouping): a plain reshape."""
        return self.perm == tuple(range(len(self.atoms)))

    @property
    def effectively_identity(self) -> bool:
        """Data order unchanged: non-unit atoms appear in source order (unit
        dims may be inserted/moved freely — they carry no data)."""
        v = self._eff_ident
        if v is None:
            nonunit = [p for p in self.perm if self.atoms[p] != 1]
            v = nonunit == sorted(nonunit)
            object.__setattr__(self, "_eff_ident", v)
        return v

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def identity(shape: Sequence[int]) -> "Layout":
        shape = tuple(int(s) for s in shape)
        lay = _IDENTITY_CACHE.get(shape)
        if lay is None:
            n = len(shape)
            lay = Layout(shape, (1,) * n, tuple(range(n)), (1,) * n)
            _IDENTITY_CACHE[shape] = lay
        return lay

    # -- refinement machinery ----------------------------------------------------
    def _split_atom(self, idx: int, outer: int) -> "Layout":
        """Split atom ``idx`` (size s) into (outer, s // outer)."""
        s = self.atoms[idx]
        if s % outer != 0:
            raise NotSplitMerge(f"cannot split atom of size {s} by {outer}")
        atoms = self.atoms[:idx] + (outer, s // outer) + self.atoms[idx + 1 :]
        # src_groups: the group containing idx gains one atom
        sg, acc = list(self.src_groups), 0
        for gi, g in enumerate(sg):
            if acc + g > idx:
                sg[gi] += 1
                break
            acc += g
        # perm: remap, expanding idx -> idx, idx+1 (consecutive, same dst slot)
        perm: list[int] = []
        for p in self.perm:
            if p < idx:
                perm.append(p)
            elif p == idx:
                perm.extend((idx, idx + 1))
            else:
                perm.append(p + 1)
        # dst_groups: the dst group containing position-of-idx gains one atom
        pos = self.perm.index(idx)
        dg, acc = list(self.dst_groups), 0
        for gi, g in enumerate(dg):
            if acc + g > pos:
                dg[gi] += 1
                break
            acc += g
        return Layout(tuple(atoms), tuple(sg), tuple(perm), tuple(dg))

    def _regroup_dst(self, new_sizes: Sequence[int]) -> "Layout":
        """Regroup dst atoms into ``new_sizes``, refining atoms as needed."""
        new_sizes = tuple(int(s) for s in new_sizes)
        if _prod(new_sizes) != _prod(self.atoms):
            raise NotSplitMerge(f"reshape size mismatch {self.dst_shape} -> {new_sizes}")
        lay = self
        # walk dst atom sequence, cutting at each new-dim boundary
        groups: list[int] = []
        ai = 0  # index into lay.perm (dst order)
        for size in new_sizes:
            need, count = size, 0
            while need > 1:
                if ai >= len(lay.perm):
                    raise NotSplitMerge("ran out of atoms")
                a = lay.atoms[lay.perm[ai]]
                if need % a == 0:
                    need //= a
                    ai += 1
                    count += 1
                elif a % need == 0:
                    lay = lay._split_atom(lay.perm[ai], need)
                    # after split, dst position ai now holds atom of size `need`
                    need = 1
                    ai += 1
                    count += 1
                else:
                    raise NotSplitMerge(
                        f"reshape {self.dst_shape} -> {new_sizes} crosses atom "
                        f"boundaries (atom {a} vs needed {need})"
                    )
            if size == 1 and count == 0:
                # unit dim: attach zero atoms -> represent with a synthetic atom of 1
                lay = lay._insert_unit_atom(ai)
                count = 1
                ai += 1
            groups.append(count)
        # absorb trailing size-1 atoms into the last group
        while ai < len(lay.perm):
            if lay.atoms[lay.perm[ai]] != 1:
                raise NotSplitMerge("leftover non-unit atoms")
            groups[-1] += 1
            ai += 1
        return Layout(lay.atoms, lay.src_groups, lay.perm, tuple(groups))

    def _insert_unit_atom(self, dst_pos: int) -> "Layout":
        """Insert a fresh size-1 atom at dst position ``dst_pos`` (appended to
        the last src group so src_shape is unchanged)."""
        idx = len(self.atoms)
        atoms = self.atoms + (1,)
        sg = list(self.src_groups) or [0]
        sg[-1] += 1
        perm = list(self.perm)
        perm.insert(dst_pos, idx)
        return Layout(atoms, tuple(sg), tuple(perm), self.dst_groups)

    # -- op application (on the destination side) ---------------------------------
    def then_reshape(self, new_sizes: Sequence[int]) -> "Layout":
        new_sizes = tuple(int(s) for s in new_sizes)
        return _op_memo(("r", _layout_id(self), new_sizes),
                        lambda: self._regroup_dst(new_sizes))

    def then_transpose(self, axes: Sequence[int]) -> "Layout":
        axes = tuple(int(a) for a in axes)
        if sorted(axes) != list(range(len(self.dst_groups))):
            raise ValueError(f"bad transpose {axes} for rank {len(self.dst_groups)}")
        return _op_memo(("t", _layout_id(self), axes),
                        lambda: self._transpose_uncached(axes))

    def _transpose_uncached(self, axes: tuple[int, ...]) -> "Layout":
        # dst runs
        runs, i = [], 0
        for g in self.dst_groups:
            runs.append(self.perm[i : i + g])
            i += g
        perm = tuple(p for a in axes for p in runs[a])
        dst_groups = tuple(self.dst_groups[a] for a in axes)
        return Layout(self.atoms, self.src_groups, perm, dst_groups)

    def then(self, op: str, arg) -> "Layout":
        if op == "reshape":
            return self.then_reshape(arg)
        if op == "transpose":
            return self.then_transpose(arg)
        raise ValueError(op)

    # -- algebra ---------------------------------------------------------------
    def _refined_to(self, boundaries: list[list[int]]) -> "Layout":
        """Refine so each src dim's atom cut-points include ``boundaries``
        (list per src dim of cumulative products that must be boundaries)."""
        lay = self
        for d, cuts in enumerate(boundaries):
            for cut in cuts:
                # find atom containing this cumulative position within dim d
                while True:
                    start = sum(lay.src_groups[:d])
                    n_atoms = lay.src_groups[d]
                    acc = 1
                    done = False
                    for k in range(start, start + n_atoms):
                        a = lay.atoms[k]
                        if acc * a > cut and cut > acc - 1 and cut % acc == 0 and cut // acc > 1:
                            if acc * a == cut * (acc * a // cut):
                                pass
                        if acc == cut:
                            done = True
                            break
                        if acc < cut < acc * a:
                            if cut % acc != 0 or a % (cut // acc) != 0:
                                raise NotSplitMerge("incompatible refinement")
                            lay = lay._split_atom(k, cut // acc)
                            break
                        acc *= a
                    else:
                        done = True
                    if done:
                        break
        return lay

    @staticmethod
    def _cuts(atoms: Sequence[int], groups: Sequence[int]) -> list[list[int]]:
        """Cumulative-product cut points per dim (excluding 1 and full size)."""
        out, i = [], 0
        for g in groups:
            cuts, acc = [], 1
            for k in range(i, i + g):
                acc *= atoms[k]
                cuts.append(acc)
            out.append(cuts[:-1])
            i += g
        return out

    def common_refine(self, other: "Layout") -> tuple["Layout", "Layout"]:
        if self.src_shape != other.src_shape:
            raise ValueError(f"src mismatch {self.src_shape} vs {other.src_shape}")
        a = self._refined_to(self._cuts(other.atoms, other.src_groups))
        b = other._refined_to(other._cuts(a.atoms, a.src_groups))
        a = a._refined_to(a._cuts(b.atoms, b.src_groups))
        return a, b

    def equivalent(self, other: "Layout") -> bool:
        """True iff the two bijections are semantically identical.

        Unit atoms carry no data: both the atom list and the permutation are
        compared on non-unit atoms only (renumbered in source order)."""
        if self is other or self == other:
            return True
        if self.src_shape != other.src_shape or self.dst_shape != other.dst_shape:
            return False
        try:
            a, b = self.common_refine(other)
        except NotSplitMerge:
            return False

        def sig(lay: Layout):
            nonunit = [i for i in range(len(lay.atoms)) if lay.atoms[i] != 1]
            rank = {idx: j for j, idx in enumerate(nonunit)}
            atoms = tuple(lay.atoms[i] for i in nonunit)
            perm = tuple(rank[p] for p in lay.perm if p in rank)
            return atoms, perm

        return sig(a) == sig(b)

    def compose(self, other: "Layout") -> "Layout":
        """self ; other  (apply self first). other.src_shape == self.dst_shape."""
        if other.src_shape != self.dst_shape:
            raise ValueError(f"compose mismatch {self.dst_shape} vs {other.src_shape}")
        return _op_memo(("c", _layout_id(self), _layout_id(other)),
                        lambda: self._compose_uncached(other))

    def _compose_uncached(self, other: "Layout") -> "Layout":
        lay = self
        # replay other's definition as ops on self: reshape to other's atom
        # shape (in other-src order), transpose by other's perm, reshape to
        # other's dst shape.
        o_atoms_src = [other.atoms[i] for i in range(len(other.atoms))]
        lay = lay.then_reshape(tuple(o_atoms_src))
        lay = lay.then_transpose(other.perm)
        return lay.then_reshape(other.dst_shape)

    def inverse(self) -> "Layout":
        inv = [0] * len(self.perm)
        for k, p in enumerate(self.perm):
            inv[p] = k
        # atoms in dst order become the source atoms of the inverse
        atoms = tuple(self.atoms[p] for p in self.perm)
        return Layout(atoms, self.dst_groups, tuple(inv), self.src_groups)

    # -- Algorithm 2 step 4: repair-op synthesis ------------------------------------
    def synthesize_ops(self) -> list[tuple[str, tuple[int, ...]]]:
        """Concrete ``[reshape, transpose, reshape]`` realizing this bijection."""
        ops: list[tuple[str, tuple[int, ...]]] = []
        atom_shape = tuple(self.atoms)
        if atom_shape != self.src_shape:
            ops.append(("reshape", atom_shape))
        if self.perm != tuple(range(len(self.atoms))):
            ops.append(("transpose", self.perm))
        if self.dst_shape != self._group_shape(self.atoms, (1,) * len(self.atoms), self.perm):
            ops.append(("reshape", self.dst_shape))
        return ops

    # -- concrete application (test oracle) ---------------------------------------
    def apply(self, x: np.ndarray) -> np.ndarray:
        assert tuple(x.shape) == self.src_shape, (x.shape, self.src_shape)
        y = x.reshape(self.atoms)
        y = y.transpose(self.perm)
        return y.reshape(self.dst_shape)

    def __repr__(self) -> str:  # compact
        return (
            f"Layout({self.src_shape}->{self.dst_shape} atoms={self.atoms} "
            f"perm={self.perm})"
        )


# -----------------------------------------------------------------------------
# Inference entry points used by the relational rules


def layout_of_ops(
    src_shape: Sequence[int], ops: Sequence[tuple[str, Sequence[int]]]
) -> Optional[Layout]:
    """Layout of a reshape/transpose sequence, or None if not split/merge."""
    lay = Layout.identity(src_shape)
    try:
        for op, arg in ops:
            lay = lay.then(op, arg)
    except (NotSplitMerge, ValueError):
        return None
    return lay


def infer_bijection(
    base_ops_layout: Layout, dist_ops_layout: Layout
) -> Optional[list[tuple[str, tuple[int, ...]]]]:
    """Algorithm 2: given the two paths' layouts (both from the *same* source
    tensor), return the repair op sequence mapping the distributed result onto
    the baseline result, or ``[]`` if they are already equivalent, or ``None``
    if no split/merge bijection exists."""
    try:
        delta = dist_ops_layout.inverse().compose(base_ops_layout)
    except (NotSplitMerge, ValueError):
        return None
    if delta.is_identity:
        return []
    return delta.synthesize_ops()

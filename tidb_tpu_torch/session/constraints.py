"""CHECK and FOREIGN KEY constraints on the write path.

Counterpart of the JAX session's constraint methods (``_check_exprs_for``,
``_enforce_write_constraints``, ``_fk_children``, ``_fk_undo_snapshot``,
``_enforce_parent_constraints`` with its ON DELETE actions,
``_fk_recheck_children``, ``_null_child_keys``, ``_cascade_delete``, the
ON UPDATE plans and ``_filter_ignore``'s CHECK and FOREIGN KEY drops). A
mixin of ``Session``: every method runs in a session's context.

A CHECK is evaluated row by row over the incoming rows
(``checkeval.eval_check``) and fails only on FALSE. A FOREIGN KEY keeps
the JAX package's results and error texts but not its algorithm: the JAX
session decodes every value of the parent column into a Python set on
each checked write and tests each child row in Python, minutes at TPC-H
SF10. Here a key set is a sorted array of encoded values (``KeySet``:
the column's range index or uniqueness index, less the values a
statement removed, plus those it added), and membership is one
vectorized search (or a bitmap over a dense integer range) over a
block's encoded column. Strings compare by value: a child's dictionary
is mapped onto the parent's value set, never code to code. Only the few
values an error prints are decoded.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn, column_from_values
from tidb_tpu_torch.dtypes import Kind
from tidb_tpu_torch.utils.checkeval import _truth, eval_check
from tidb_tpu_torch.utils.failpoint import inject

_NUMERIC = (Kind.INT, Kind.DECIMAL, Kind.FLOAT, Kind.BOOL)

#: ON DELETE / ON UPDATE chains deeper than this raise
_FK_DEPTH = 10


def fk_domain(ctype, ptype) -> str:
    """The domain a child column and its parent column compare in:
    ``enc`` (the same encoding: one kind, one DECIMAL scale), ``str``
    (strings by value), ``num`` (numbers by value, as floats) or ``obj``
    (decoded values)."""
    if ctype.kind == Kind.STRING and ptype.kind == Kind.STRING:
        return "str"
    if ctype.kind == ptype.kind and (ctype.kind != Kind.DECIMAL or ctype.scale == ptype.scale):
        return "enc"
    if ctype.kind in _NUMERIC and ptype.kind in _NUMERIC:
        return "num"
    return "obj"


def natural_domain(typ) -> str:
    return "str" if typ.kind == Kind.STRING else "enc"


def domain_values(col: HostColumn, domain: str) -> np.ndarray:
    """Every row's value of `col` in `domain` (a NULL row holds filler)."""
    if domain == "enc":
        return col.data
    if domain == "num":
        if col.type.kind == Kind.DECIMAL:
            return col.data / 10 ** col.type.scale
        return col.data.astype(np.float64)
    if domain == "str":
        d = col.dictionary
        if d is None or not len(d):
            return np.full(len(col.data), "", dtype=object)
        return np.asarray(d, dtype=object)[np.clip(col.data, 0, len(d) - 1)]
    return col.decode()


def _unique(a: np.ndarray) -> np.ndarray:
    if a.dtype == object and len(a) and not all(isinstance(v, str) for v in a[:64]):
        return np.array(list(dict.fromkeys(a.tolist())), dtype=object)
    return np.unique(a)


def in_sorted(keys: np.ndarray, values: np.ndarray, lut=None) -> np.ndarray:
    """Per value: whether it is one of the sorted `keys`: a lookup in
    `lut` ((low key, table over the key range), from ``dense_lut``) when
    given, else a binary search; object arrays of non-strings test a
    set."""
    if not len(keys) or not len(values):
        return np.zeros(len(values), dtype=bool)
    if lut is not None:
        lo, table = lut
        idx = values.astype(np.int64) - lo
        out = (idx >= 0) & (idx < len(table))
        out[out] = table[idx[out]]
        return out
    if keys.dtype == object and not isinstance(keys[0], str):
        s = set(keys.tolist())
        return np.fromiter((v in s for v in values.tolist()), dtype=bool, count=len(values))
    pos = np.searchsorted(keys, values)
    np.clip(pos, 0, len(keys) - 1, out=pos)
    return keys[pos] == values


def dense_lut(keys: np.ndarray):
    """(low key, boolean table over [low, high]) of sorted integer keys
    whose range is dense enough to index (at most 4 slots a key), else
    None."""
    if not len(keys) or keys.dtype.kind not in "iu":
        return None
    lo, hi = int(keys[0]), int(keys[-1])
    if hi - lo + 1 > 4 * len(keys) + 1024:
        return None
    table = np.zeros(hi - lo + 1, dtype=bool)
    table[keys.astype(np.int64) - lo] = True
    return lo, table


class KeySet:
    """A set of key values in one domain: the sorted `base` (repeats
    allowed) less the sorted unique `minus`, plus the sorted unique
    `plus`. A statement's post-image of a column is the stored column's
    sorted values with what it removed and added, so nothing is sorted
    again. Membership searches the sorted arrays; a large probe of a
    dense integer `base` builds a lookup table once and reuses it for
    every later probe of the set (each block of a child table)."""

    def __init__(self, base, minus=None, plus=None):
        self.base = base
        self.minus = minus if minus is not None else base[:0]
        self.plus = plus if plus is not None else base[:0]
        self._luts: dict = {}  # part -> dense_lut(part), once built

    def _probe(self, part: str, values: np.ndarray) -> np.ndarray:
        keys = getattr(self, part)
        lut = self._luts.get(part)
        # a table costs a pass over the key range, a search a log of the
        # keys a value; the table serves every later probe too (a child
        # table's blocks), so a probe of a few percent of it pays
        if lut is None and keys.dtype.kind in "iu" and values.dtype.kind in "iu" and \
                len(values) * max(len(keys), 2).bit_length() > len(keys) // 4:
            lut = self._luts[part] = dense_lut(keys) or ()
        return in_sorted(keys, values, lut or None)

    def contains(self, values: np.ndarray) -> np.ndarray:
        hit = self._probe("base", values)
        if len(self.minus):
            hit &= ~self._probe("minus", values)
        if len(self.plus):
            hit |= self._probe("plus", values)
        return hit

    def values(self) -> np.ndarray:
        """The set's members, unique."""
        base = _unique(self.base)
        if len(self.minus):
            base = base[~in_sorted(self.minus, base)]
        if len(self.plus):
            base = _unique(np.concatenate([base, self.plus]))
        return base

    def with_plus(self, extra: np.ndarray) -> "KeySet":
        if not len(extra):
            return self
        plus = _unique(np.concatenate([self.plus, extra])) if len(self.plus) else _unique(extra)
        return KeySet(self.base, self.minus, plus)

    def to_domain(self, typ, domain: str) -> "KeySet":
        """The same set in another domain (from this column's natural
        one): a DECIMAL's scaled integers as numbers, encoded values as
        decoded ones."""
        if domain in ("enc", "str"):
            return self

        def conv(a):
            return domain_values(HostColumn(typ, a, np.ones(len(a), dtype=bool)), domain)

        return KeySet(conv(self.base), conv(self.minus), conv(self.plus))


def member_mask(col: HostColumn, keys: KeySet, domain: str) -> np.ndarray:
    """Per row of `col`: valid and its value in `keys`. A string column
    maps its dictionary onto the set once and gathers by code."""
    if domain == "str":
        d = col.dictionary
        if d is None or not len(d):
            return np.zeros(len(col.data), dtype=bool)
        lut = keys.contains(np.asarray(d, dtype=object))
        return col.valid & lut[np.clip(col.data, 0, len(d) - 1)]
    return col.valid & keys.contains(domain_values(col, domain))


def multiset_removed(sorted_all: np.ndarray, removed: np.ndarray) -> np.ndarray:
    """Of the values in `removed` (a multiset taken out of the multiset
    `sorted_all`, sorted), those with no occurrence left, sorted unique."""
    if not len(removed):
        return removed
    u, counts = np.unique(removed, return_counts=True)
    have = np.searchsorted(sorted_all, u, side="right") - np.searchsorted(sorted_all, u, side="left")
    return u[have <= counts]


def decode_values(typ, values: np.ndarray) -> list:
    """Natural-domain values decoded as the JAX package's ``decode()``."""
    if typ.kind == Kind.STRING:
        return list(values)
    col = HostColumn(typ, np.asarray(values).astype(typ.np_dtype), np.ones(len(values), dtype=bool))
    return col.decode().tolist()


class ConstraintMixin:
    # -- CHECK -------------------------------------------------------------
    def _check_exprs_for(self, t):
        """[(name, parsed expression)] of a table's CHECKs, parsed once."""
        from tidb_tpu_torch.parser.sqlparse import parse_expr

        exprs = getattr(t, "_check_exprs", None)
        if exprs is None or len(exprs) != len(t.checks):
            exprs = t._check_exprs = [(nm, parse_expr(txt)) for nm, txt in t.checks]
        return exprs

    @staticmethod
    def _check_rows_with(exprs, dict_rows) -> None:
        """CHECKs over row dicts, in the JAX order: each constraint over
        every row; one fails only on FALSE."""
        for nm, ex in exprs:
            for rd in dict_rows:
                if _truth(eval_check(ex, rd)) is False:
                    raise ValueError(f"CHECK constraint {nm!r} violated")

    # -- key sets ----------------------------------------------------------
    def _column_keyset(self, db: str, name: str, col: str) -> KeySet:
        """The valid values of a column at this statement's read version,
        in its natural domain: the uniqueness index (merged on each
        append) for the current version, else the range index of the
        version read; a string column's values in use, by value."""
        t, version = self._resolve_table_for_read(db, name)
        return self._table_keyset(t, col, version)

    @staticmethod
    def _table_keyset(t, col: str, version=None) -> KeySet:
        typ = t.schema.types[col]
        if typ.kind == Kind.STRING:
            d = t.dictionaries.get(col)
            if d is None or not len(d):
                return KeySet(np.zeros(0, dtype=object))
            used = np.zeros(len(d), dtype=bool)
            for b in t.blocks(version):
                c = b.columns.get(col)
                if c is not None and len(c.data):
                    used[np.clip(c.data[c.valid], 0, len(d) - 1)] = True
            return KeySet(np.asarray(d, dtype=object)[used])
        if version is None or version == t.version:
            return KeySet(t._sorted_values(col))
        svals, _perm, nvalid = t._sorted_index(col, version)
        return KeySet(svals[:nvalid])

    def _keyset_after(self, t, col: str, removed: np.ndarray, added=None) -> KeySet:
        """A column's current value set after a statement removes the
        multiset `removed` and adds `added` (natural-domain arrays)."""
        base = self._table_keyset(t, col)
        typ = t.schema.types[col]
        if typ.kind == Kind.STRING:
            # by value: a string leaves the set when no row keeps it
            d = np.asarray(t.dictionaries.get(col), dtype=object)
            gone = np.zeros(0, dtype=object)
            if len(removed):
                left = np.zeros(len(d), dtype=np.int64)
                for b in t.blocks():
                    c = b.columns.get(col)
                    if c is not None:
                        left += np.bincount(c.data[c.valid], minlength=len(d))[:len(d)]
                codes = np.searchsorted(d, removed)
                left -= np.bincount(codes, minlength=len(d))[:len(d)]
                gone = d[(left <= 0) & np.isin(np.arange(len(d)), codes)]
            ks = KeySet(base.base, np.sort(gone))
        else:
            ks = KeySet(base.base, multiset_removed(base.base, np.sort(removed)))
        return ks.with_plus(np.asarray(added)) if added is not None and len(added) else ks

    def _rows_keyset(self, t, col: str, values: list) -> KeySet:
        """The set of Python values of a column (a row image's), encoded
        into its natural domain."""
        typ = t.schema.types[col]
        vals = [v for v in values if v is not None]
        if typ.kind == Kind.STRING:
            return KeySet(np.array(sorted({str(v) for v in vals}), dtype=object))
        return KeySet(np.unique(column_from_values(vals, typ).data))

    def _incoming(self, vals: list, typ, domain: str):
        """(domain values, valid mask) of incoming Python values."""
        col = column_from_values(vals, typ)
        return domain_values(col, domain), col.valid

    # -- the child side ----------------------------------------------------
    def _enforce_write_constraints(self, t, db: str, rows) -> None:
        """CHECK and the child side of every FOREIGN KEY over full Python
        rows, before they are encoded and appended. A self-referential
        FOREIGN KEY admits the keys arriving in the same rows."""
        names = t.schema.names
        if t.checks:
            self._check_rows_with(self._check_exprs_for(t), [dict(zip(names, r)) for r in rows])
        for nm, col, rdb, rtbl, rcol in t.fks:
            i = names.index(col)
            vals = [r[i] for r in rows]
            if all(v is None for v in vals):
                continue
            self._fk_child_check(t, db, nm, col, rdb, rtbl, rcol, vals,
                                 [r[names.index(rcol)] for r in rows]
                                 if rdb == db.lower() and rtbl == t.name else None)

    def _fk_child_check(self, t, db, nm, col, rdb, rtbl, rcol, vals, self_vals=None,
                        shown=None) -> None:
        """Raise the JAX package's error when a non-NULL value of `vals`
        (the child column's new values) is not among the parent's. The
        error prints the first three missing values sorted, as given
        (`shown`: the values to print, aligned to `vals`)."""
        ptype = self._parent_type(rdb, rtbl, rcol, t if self_vals is not None else None)
        ctype = t.schema.types[col]
        domain = fk_domain(ctype, ptype)
        keys = self._column_keyset(rdb, rtbl, rcol).to_domain(ptype, domain)
        if self_vals is not None:
            sv, svalid = self._incoming(self_vals, ptype, domain)
            keys = keys.with_plus(_unique(sv[svalid]))
        dv, valid = self._incoming(vals, ctype, domain)
        miss = valid & ~keys.contains(dv)
        if miss.any():
            shown = vals if shown is None else shown
            missing = {shown[j] for j in np.flatnonzero(miss)}
            raise ValueError(
                f"FOREIGN KEY {nm!r} violated: "
                f"{sorted(missing)[:3]!r} not in {rdb}.{rtbl}.{rcol}")

    def _parent_type(self, rdb, rtbl, rcol, self_table=None):
        t = self_table if self_table is not None else self.catalog.table(rdb, rtbl)
        return t.schema.types[rcol]

    # -- the parent side ---------------------------------------------------
    def _fk_children(self, db: str, name: str) -> list:
        return self.catalog.fk_children(db, name)

    def _fk_undo_snapshot(self, undo, t) -> None:
        """A table's state before the statement, once per statement, so a
        failure anywhere in a chain of referential actions restores every
        table it touched."""
        if undo is not None and all(u[0] is not t for u in undo):
            undo.append((t, list(t.blocks()), dict(t.dictionaries)))

    def _fk_undo_restore(self, undo) -> None:
        for t, blocks, dicts in undo:
            t.replace_blocks(blocks, modified_rows=0)
            t.dictionaries = dicts
        self._drop_cached(invalidate=[u[0] for u in undo])

    def _enforce_parent_constraints(self, db: str, name: str, remaining: dict,
                                    actions: bool = False, _depth: int = 0, undo=None,
                                    update_acts=None) -> None:
        """The parent side of every FOREIGN KEY referencing db.name after
        a statement that removed or rewrote its keys: `remaining` maps a
        referenced column to its post-statement ``KeySet``. With
        `actions` (DELETE, TRUNCATE) each child's ON DELETE action
        applies: RESTRICT raises, CASCADE deletes the child rows that
        dangle (recursively), SET NULL clears their key. With
        `update_acts` ((child db, child table, fk) -> ON UPDATE action),
        RESTRICT raises and the caller applies CASCADE and SET NULL after
        installing the new rows. Otherwise RESTRICT."""
        if _depth > _FK_DEPTH:
            raise ValueError("FOREIGN KEY cascade recursion too deep")
        ptable = None
        for cdb, ctn, nm, col, rcol, odel in self._fk_children(db, name):
            if rcol not in remaining:
                continue
            if update_acts is not None:
                act = update_acts.get((cdb, ctn, nm), "restrict")
                if act in ("cascade", "set_null"):
                    continue
            elif actions:
                act = odel
            else:
                act = "restrict"
            if ptable is None:
                ptable = self.catalog.table(db, name)
            ptype = ptable.schema.types[rcol]
            ct, cversion = self._resolve_table_for_read(cdb, ctn)
            ctype = ct.schema.types[col]
            domain = fk_domain(ctype, ptype)
            keys = remaining[rcol].to_domain(ptype, domain)
            self_fk = cdb == db.lower() and ctn == name.lower()
            if self_fk and col in remaining:
                # the child side shrinks with the parent: the caller's
                # post-statement set of the FK column is the truth
                cvals = remaining[col].to_domain(ctype, domain).values()
                dangling_vals = cvals[~keys.contains(cvals)]
            else:
                parts, hits = [], {}
                for b in ct.blocks(cversion):
                    c = b.columns.get(col)
                    if c is None:
                        continue
                    hit = c.valid & ~member_mask(c, keys, domain)
                    hits[b.uid] = hit
                    if hit.any():
                        parts.append(domain_values(c, domain)[hit])
                dangling_vals = _unique(np.concatenate(parts)) if parts else None
            if dangling_vals is None or not len(dangling_vals):
                continue
            # the action finds these masks by block: a block the read
            # version shares with the written one is not searched again
            dangling = KeySet(dangling_vals)
            dangling.hits = {} if self_fk and col in remaining else hits
            if act == "restrict":
                shown = self._decode_domain(ctype, domain, dangling_vals)
                raise ValueError(
                    f"FOREIGN KEY {nm!r} on {cdb}.{ctn} restricts this "
                    f"statement: {sorted(shown)[:3]!r} still referenced")
            if act == "set_null":
                self._null_child_keys(cdb, ctn, col, (dangling, domain), _depth, undo)
            else:  # cascade (the delete paths only)
                self._cascade_delete(cdb, ctn, col, (dangling, domain), _depth, undo)

    @staticmethod
    def _decode_domain(ctype, domain: str, values: np.ndarray) -> list:
        """The first three of a set of domain values, in order, as the JAX
        package's decoded child values (only those are decoded)."""
        if domain == "obj":
            return values.tolist()
        head = _unique(values)[:3]
        if domain == "enc":
            return decode_values(ctype, head)
        if domain == "num" and ctype.kind in (Kind.INT, Kind.BOOL):
            return [int(v) for v in head.tolist()]
        return head.tolist()

    @staticmethod
    def _child_block_mask(block, col, spec) -> np.ndarray:
        """Rows of `block` whose `col` is in the dangling set `spec`
        ((KeySet, domain)); NULLs never match."""
        c = block.columns.get(col)
        if c is None:
            return np.zeros(block.nrows, dtype=bool)
        keys, domain = spec
        hit = getattr(keys, "hits", {}).get(block.uid)
        return hit if hit is not None else member_mask(c, keys, domain)

    def _fk_recheck_children(self, cdb, ctn, depth, undo, cols=None) -> None:
        """After a child table changed (cascade delete, SET NULL, ON
        UPDATE CASCADE), its own children may dangle: apply their actions
        against its new value sets of every column they reference (of
        `cols`, the columns that changed; None: all)."""
        ref_cols = {rc for _cd, _ct, _nm, _c, rc, _a in self._fk_children(cdb, ctn)
                    if cols is None or rc in cols}
        if ref_cols:
            remaining = {rc: self._column_keyset(cdb, ctn, rc) for rc in ref_cols}
            self._enforce_parent_constraints(cdb, ctn, remaining, actions=True,
                                             _depth=depth + 1, undo=undo)

    def _null_child_keys(self, cdb, ctn, col, spec, depth, undo) -> None:
        """SET NULL: clear the child's key where it referenced a removed
        parent key, then recheck the child's own children."""
        t = self._resolve_table_for_write(cdb, ctn)
        self._fk_undo_snapshot(undo, t)
        new_blocks, changed = [], 0
        for b in t.blocks():
            hit = self._child_block_mask(b, col, spec)
            if not hit.any():
                new_blocks.append(b)
                continue
            cols = dict(b.columns)
            c = cols[col]
            cols[col] = dataclasses.replace(c, valid=c.valid & ~hit)
            new_blocks.append(HostBlock(cols, b.nrows, part_id=b.part_id))
            changed += int(hit.sum())
        if changed:
            t.replace_blocks(new_blocks, modified_rows=changed)
            self._drop_cached(invalidate=[t])
            self._fk_recheck_children(cdb, ctn, depth, undo, cols={col})

    def _cascade_delete(self, cdb, ctn, col, spec, depth, undo) -> None:
        """ON DELETE CASCADE: delete the child rows that referenced a
        removed parent key, then apply the child's own ON DELETE
        actions."""
        inject("fk/cascade-delete")
        t = self._resolve_table_for_write(cdb, ctn)
        self._fk_undo_snapshot(undo, t)
        keep = [~self._child_block_mask(b, col, spec) for b in t.blocks()]
        if all(m.all() for m in keep):
            return
        t.delete_where(keep)
        self._drop_cached(invalidate=[t])
        self._fk_recheck_children(cdb, ctn, depth, undo)

    def _parent_need(self, t, db: str, children) -> set:
        """The columns whose post-statement sets the parent check needs:
        every referenced column, and a self-referential FK's own column."""
        need = {rc for _cd, _ct, _nm, _c, rc, _a in children}
        need |= {c for cd, ct, _nm, c, _rc, _a in children
                 if cd == db.lower() and ct == t.name}
        return need

    def _delete_masked(self, t, db: str, table_name: str, masks, affected,
                       undo=None, deferred=None):
        """Delete the rows of per-block masks (True: delete) with the
        referential actions: the post-statement sets of the referenced
        columns come from the masks, the rows go first so a cascade sees
        the post-statement state, and every touched table is restored
        when a RESTRICT fires anywhere in the chain. A multi-table DELETE
        shares `undo` and defers the actions (`deferred`) until all its
        targets are deleted, so a cascade never moves rows a later target's
        masks refer to."""
        from tidb_tpu_torch.session.session import Result

        children = self._fk_children(db, table_name)
        remaining = None
        if children and affected:
            remaining = {}
            for col in self._parent_need(t, db, children):
                removed = [b.columns[col].data[m & b.columns[col].valid]
                           for b, m in zip(t.blocks(), masks) if col in b.columns]
                removed = np.concatenate(removed) if removed else np.zeros(0, dtype=np.int64)
                if t.schema.types[col].kind == Kind.STRING:
                    d = t.dictionaries.get(col)
                    removed = np.asarray(d, dtype=object)[removed] if len(removed) else \
                        np.zeros(0, dtype=object)
                remaining[col] = self._keyset_after(t, col, removed)
        shared = undo is not None
        undo = undo if shared else []
        self._fk_undo_snapshot(undo, t)
        t.delete_where([~m for m in masks])

        def act():
            if remaining is not None:
                self._enforce_parent_constraints(db, table_name, remaining, actions=True,
                                                 undo=undo)

        if deferred is not None:
            deferred.append(act)
            return Result([], [], affected=affected)
        try:
            act()
        except BaseException:
            self._fk_undo_restore(undo)
            raise
        finally:
            self._drop_cached(invalidate=[u[0] for u in undo])
        return Result([], [], affected=affected)

    def _clear_with_actions(self, t, db: str, name: str, modified: int) -> None:
        """Remove every row of `t` (DELETE without WHERE, TRUNCATE) and
        apply its children's ON DELETE actions against empty sets."""
        children = self._fk_children(db, name)
        undo: list = []
        self._fk_undo_snapshot(undo, t)
        t.replace_blocks([], modified_rows=modified)
        try:
            if children:
                empty = {c: KeySet(np.zeros(0, dtype=object if typ.kind == Kind.STRING
                                            else typ.np_dtype))
                         for c, typ in t.schema.columns}
                self._enforce_parent_constraints(db, name, empty, actions=True, undo=undo)
        except BaseException:
            self._fk_undo_restore(undo)
            raise
        finally:
            self._drop_cached(invalidate=[u[0] for u in undo])

    # -- ON UPDATE -----------------------------------------------------------
    def _fk_upd_acts(self, children) -> dict:
        """(child db, child table, fk) -> ON UPDATE action of each child
        FK (the action maps are keyed by the lower-cased name)."""
        return {(cdb, ctn, nm): self.catalog.table(cdb, ctn).fk_update_actions.get(
                    nm.lower(), "restrict")
                for cdb, ctn, nm, _c, _rc, _a in children}

    def _fk_update_guard(self, t, db, name, children, remaining, pairs, undo):
        """The parent side of an UPDATE over `children` (the child FKs the
        statement can reach): `remaining` maps their referenced columns
        (and a self-referential FK's own) to the post-image ``KeySet``;
        `pairs(rcol)` gives (old keys, new keys, new validity, kept) of
        the rows whose old key is valid: every row of a rewrite, or the
        touched rows of the columnar form, whose `kept(old)` says an
        untouched row keeps the key. RESTRICT children are checked now;
        the CASCADE and SET NULL plans come back to apply once the new
        rows are installed."""
        if not children:
            return []
        upd_acts = self._fk_upd_acts(children)
        action_children = [c for c in children
                           if upd_acts[(c[0], c[1], c[2])] in ("cascade", "set_null")]
        plans = (self._fk_update_plans(t, action_children, upd_acts, remaining, pairs)
                 if action_children else [])
        self._enforce_parent_constraints(db, name, remaining, update_acts=upd_acts, undo=undo)
        return plans

    def _fk_update_plans(self, t, action_children, upd_acts, remaining, pairs):
        """Post-install child actions: [("cascade", db, table, column,
        (old keys, new keys, their type)) | ("set_null", db, table,
        column, (KeySet, domain))].
        One old key paired with two outcomes (possible only when the
        referenced column is not unique) aborts rather than guessing; a
        cascade to NULL becomes a SET NULL."""
        out = []
        for cdb, ctn, nm, ccol, rcol, _odel in action_children:
            act = upd_acts[(cdb, ctn, nm)]
            typ = t.schema.types[rcol]
            dom = fk_domain(self.catalog.table(cdb, ctn).schema.types[ccol], typ)

            def nulls(keys):
                return "set_null", cdb, ctn, ccol, (KeySet(np.sort(keys)).to_domain(typ, dom), dom)

            olds, news, new_valid, kept = pairs(rcol)
            if act == "set_null":
                gone = _unique(olds)
                gone = gone[~remaining[rcol].contains(gone)]
                if len(gone):
                    out.append(nulls(gone))
                continue
            mapping_old, mapping_new, null_olds = [], [], []
            if len(olds):
                order = np.argsort(olds, kind="stable")
                so, sn, sv = olds[order], news[order], new_valid[order]
                starts = np.flatnonzero(np.r_[True, so[1:] != so[:-1]])
                ends = np.r_[starts[1:], len(so)]
                for a, b in zip(starts.tolist(), ends.tolist()):
                    old = so[a]
                    outcomes = {(bool(v), n if v else None) for n, v in zip(sn[a:b].tolist(),
                                                                            sv[a:b].tolist())}
                    if kept is not None and kept(old):
                        outcomes.add((True, old.item() if hasattr(old, "item") else old))
                    if len(outcomes) > 1:
                        shown = decode_values(typ, np.array([old], dtype=olds.dtype))[0]
                        raise ValueError(
                            f"ON UPDATE CASCADE: ambiguous rewrite of {rcol!r} value {shown!r}")
                    ok, new = next(iter(outcomes))
                    if not ok:
                        null_olds.append(old)
                    elif new != old:
                        mapping_old.append(old)
                        mapping_new.append(new)
            if mapping_old:
                out.append(("cascade", cdb, ctn, ccol,
                            (np.array(mapping_old), np.array(mapping_new), typ)))
            if null_olds:
                out.append(nulls(np.array(null_olds)))
        return out

    def _apply_fk_update_plans(self, plans, undo) -> None:
        for kind, cdb, ctn, ccol, payload in plans:
            if kind == "cascade":
                self._cascade_update_child(cdb, ctn, ccol, payload, 0, undo)
            else:
                self._null_child_keys(cdb, ctn, ccol, payload, 0, undo)

    def _cascade_update_child(self, cdb, ctn, col, mapping, depth, undo) -> None:
        """ON UPDATE CASCADE: rewrite the child's keys old -> new (encoded
        arrays), then recheck its own children."""
        inject("fk/cascade-update")
        olds, news, ptype = mapping
        if not len(olds):
            return
        t = self._resolve_table_for_write(cdb, ctn)
        ctype = t.schema.types[col]
        if ctype.kind == Kind.STRING:
            raise ValueError(
                "ON UPDATE CASCADE is not supported for string FK "
                "columns (dictionary remap); use RESTRICT or SET NULL")
        if fk_domain(ctype, ptype) != "enc":
            olds = column_from_values(decode_values(ptype, olds), ctype).data
            news = column_from_values(decode_values(ptype, news), ctype).data
        self._fk_undo_snapshot(undo, t)
        order = np.argsort(olds, kind="stable")
        so, sn = olds[order], news[order]
        new_blocks, changed = [], 0
        for b in t.blocks():
            c = b.columns[col]
            pos = np.clip(np.searchsorted(so, c.data), 0, len(so) - 1)
            hit = c.valid & (so[pos] == c.data)
            if not hit.any():
                new_blocks.append(b)
                continue
            cols = dict(b.columns)
            cols[col] = dataclasses.replace(
                c, data=np.where(hit, sn[pos], c.data).astype(c.data.dtype))
            new_blocks.append(HostBlock(cols, b.nrows, part_id=b.part_id))
            changed += int(hit.sum())
        if changed:
            t.replace_blocks(new_blocks, modified_rows=changed)
            self._drop_cached(invalidate=[t])
            self._fk_recheck_children(cdb, ctn, depth, undo, cols={col})

    def _rewrite_update_guard(self, t, db, name, names, rows, undo):
        """The parent side of a whole-table rewrite (``rows``: the full
        post-image in the stored rows' order)."""
        children = self._fk_children(db, name)
        if not children:
            return []
        remaining = {c: self._rows_keyset(t, c, [r[names.index(c)] for r in rows])
                     for c in self._parent_need(t, db, children)}

        def pairs(rcol):
            typ = t.schema.types[rcol]
            old = [b.columns[rcol] for b in t.blocks()]
            odata = np.concatenate([c.data for c in old]) if old else np.zeros(0, typ.np_dtype)
            ovalid = np.concatenate([c.valid for c in old]) if old else np.zeros(0, bool)
            if len(odata) != len(rows):
                raise ValueError("ON UPDATE CASCADE: cannot align pre/post images "
                                 f"for {rcol!r} (row set changed size)")
            if typ.kind == Kind.STRING:
                d = np.asarray(t.dictionaries.get(rcol), dtype=object)
                odata = d[np.clip(odata, 0, max(len(d) - 1, 0))] if len(d) else odata
            new = column_from_values([r[names.index(rcol)] for r in rows], typ)
            nd = domain_values(new, natural_domain(typ))
            return odata[ovalid], nd[ovalid], new.valid[ovalid], None

        return self._fk_update_guard(t, db, name, children, remaining, pairs, undo)

    # -- INSERT IGNORE ------------------------------------------------------
    def _ignore_constraint_mask(self, t, db: str, names, rows) -> list:
        """INSERT IGNORE: per row, whether it passes every CHECK and the
        child side of every FOREIGN KEY (a self-referential FK admits the
        keys of the rows kept before it), as the JAX ``_filter_ignore``
        decides row by row."""
        n = len(rows)
        ok = np.ones(n, dtype=bool)
        if t.checks:
            exprs = self._check_exprs_for(t)
            for j, r in enumerate(rows):
                rd = dict(zip(names, r))
                if any(_truth(eval_check(ex, rd)) is False for _nm, ex in exprs):
                    ok[j] = False
        self_fks = []
        for _nm, col, rdb, rtbl, rcol in t.fks:
            ctype = t.schema.types[col]
            is_self = rdb == db.lower() and rtbl == t.name
            ptype = self._parent_type(rdb, rtbl, rcol, t if is_self else None)
            domain = fk_domain(ctype, ptype)
            keys = self._column_keyset(rdb, rtbl, rcol).to_domain(ptype, domain)
            dv, valid = self._incoming([r[names.index(col)] for r in rows], ctype, domain)
            inp = ~valid | keys.contains(dv)
            if is_self:
                sv, svalid = self._incoming([r[names.index(rcol)] for r in rows], ptype, domain)
                self_fks.append((inp, dv.tolist(), valid, sv.tolist(), svalid))
            else:
                ok &= inp
        if not self_fks:
            return ok.tolist()
        out, added = [], [set() for _ in self_fks]
        for j in range(n):
            good = bool(ok[j]) and all(inp[j] or dv[j] in add
                                       for (inp, dv, _v, _sv, _svv), add in zip(self_fks, added))
            out.append(good)
            if good:
                for (_i, _d, _v, sv, svalid), add in zip(self_fks, added):
                    if svalid[j]:
                        add.add(sv[j])
        return out


"""Lazy symbolic bitvectors: record the trace, build the system on device.

The reference's defining capability is a fully generic trace — ANY Python
function run on symbolic bitvectors yields a GF(2) system
(``reference:gf2bv/__init__.py:21-134``).  Its cost model, however, is
per-op big-int work, and the round-1 eager port kept that shape: every BitVec
op materializes a packed numpy matrix on the host and ``solve_one`` uploads
the ~100 MB result.  This module makes the generic trace TPU-first:

* ``LazyBitVec`` implements the whole BitVec op surface but only RECORDS an
  expression DAG (``Expr`` nodes) — tracing MT19937 is ~20k tiny Python
  object constructions, no array math.
* The **coefficient part** of every traced equation is input-independent:
  XOR-with-constant is the only way per-instance data enters a GF(2)-linear
  trace, and it touches nothing but the affine column.  So the packed
  coefficient matrix is materialized ONCE per trace *structure* (a content
  hash over the DAG that deliberately excludes XOR constants), cached on the
  device, and reused across instances.
* Per solve, only the **affine column** is recomputed — each node's affine
  bits form a Python int bitmask, so the interpreter is ~one int op per DAG
  node — and the tiny (rows,) delta vector is fused into the solver call on
  device (ops/lazy_solve.py).

Any operation outside the recorded surface transparently materializes to the
eager packed representation (``rows`` is a property), so a LazyBitVec is
substitutable wherever a BitVec is expected, including inside the crypto
models' ``isinstance(x, BitVec)`` linearization branches.

Port copy of ``gf2bv_tpu/core/lazy.py`` (framework-free; kept identical apart from
this note and the changes listed here, so the differential tests pin it).
Change: ``_expand_products`` keeps only the numpy path, and
``GF2BV_TPU_MULBITS`` is not read.  The reference sends large batches to
its XLA expansion; its torch form here (``ops/quad_device.mul_bits_batch``)
ties or loses against numpy on the card's host at 4096-34768 products
(scripts/time_mul_bits_torch.py).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .bitvec import BitVec


def _digest(*parts: bytes) -> bytes:
    return hashlib.blake2b(b"".join(parts), digest_size=12).digest()


# small-int bytes table: widths/shift counts/indices are almost always tiny,
# and int.to_bytes is ~1.2us while a tuple index is ~0.1us — node recording
# is a pure-Python hot loop (~174k Expr constructions for the NLFSR trace)
_IB = tuple(i.to_bytes(8, "little") for i in range(4096))
_OPB: dict = {}  # op name -> encoded bytes (encode() is ~0.1us per call)


def _ints(*vals: int) -> bytes:
    return b"".join(
        _IB[v] if 0 <= v < 4096 else v.to_bytes(8, "little", signed=True)
        for v in vals
    )


def _bigint(v: int) -> bytes:
    return v.to_bytes((v.bit_length() + 7) // 8 or 1, "little")


class Param:
    """Placeholder for a per-instance XOR constant in a captured trace.

    XOR-with-constant is the only way per-instance data enters a GF(2)
    linear trace (it touches nothing but the affine column), so a DAG
    recorded once with Params can be re-solved for new constants WITHOUT
    re-running the user's model — the TPU-era version of the reference's
    pickled-trace reuse pattern
    (``reference:examples/nlfsr_ex.py:28-48``).  Structure hashes
    deliberately treat a Param exactly like a literal constant, so a
    captured trace and a direct trace of the same model share the device
    coefficient-matrix cache.
    """

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def bind(self, env) -> int:
        try:
            v = env[self.index]
        except (IndexError, KeyError, TypeError):
            raise ValueError(
                f"captured trace needs a value for param {self.index}; "
                f"got {len(env) if env is not None else 0} values"
            ) from None
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ValueError(
                f"param {self.index}: value {v!r} is not convertible to int"
            ) from None

    def __repr__(self) -> str:
        return f"Param({self.index})"


class ParamSpace:
    """Factory handed to ``LinearSystem.capture``'s model function: each
    ``p[i]`` names the i-th per-instance constant slot."""

    def __init__(self):
        self.count = 0

    def __getitem__(self, i: int) -> Param:
        i = int(i)
        if i < 0:
            raise IndexError("param indices must be >= 0")
        self.count = max(self.count, i + 1)
        return Param(i)


class Expr:
    """One node of the recorded trace.

    ``shash`` is the structural content hash: it covers the op, all params
    that influence the COEFFICIENT columns, and the children — but not XOR
    constants, which only touch the affine column and are re-applied per
    solve.  Equal shash => bit-identical coefficient matrix.

    ``aff0`` marks subgraphs whose affine column is provably all-zero
    (generators are pure-linear; only XOR/OR constants and affine-carrying
    leaves introduce affine bits).  The per-solve affine interpreter prunes
    them, so its cost scales with the number of constant-injection sites,
    not the trace size (~625 nodes instead of ~20k for MT19937).
    """

    __slots__ = ("op", "args", "aux", "width", "nbits", "shash", "aff0")

    def __init__(self, op, args, aux, width, nbits, hash_aux: bytes):
        self.op = op
        self.args = args
        self.aux = aux
        self.width = width
        self.nbits = nbits
        # one blake2b over the pre-joined message == the digest of the same
        # parts fed via update() (concatenation either way), but ~1.6x
        # faster — this constructor dominates trace-recording time
        opb = _OPB.get(op)
        if opb is None:
            opb = _OPB[op] = op.encode()
        self.shash = hashlib.blake2b(
            opb
            + (_IB[width] if 0 <= width < 4096 else _ints(width))
            + hash_aux
            + b"".join(a.shash for a in args),
            digest_size=12,
        ).digest()
        if op == "xorc":
            self.aff0 = (
                not isinstance(aux, Param)
                and args[0].aff0
                and aux & ((1 << width) - 1) == 0
            )
        elif op == "mulq":
            # product affine bit = affA & affB: zero if EITHER side is
            self.aff0 = args[0].aff0 or args[1].aff0
        elif op == "orc":
            self.aff0 = args[0].aff0 and aux == 0
        elif op == "leaf":
            self.aff0 = not bool(np.any(aux.rows[:, 0] & np.uint64(1)))
        elif len(args) == 1:  # the common case, sans generator overhead
            self.aff0 = args[0].aff0
        else:
            self.aff0 = all(a.aff0 for a in args)


def _leaf(op, payload, width, nbits, hash_aux):
    return Expr(op, (), payload, width, nbits, hash_aux)


def postorder(roots):
    """Iterate every reachable node exactly once, children before parents
    (iterative: trace DAGs are far deeper than the recursion limit)."""
    seen = set()
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            yield node
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        stack.extend((ch, False) for ch in reversed(node.args))


def struct_key(exprs, extra: bytes = b"") -> bytes:
    """Cache key for a zeros list: per-zero structural hashes + widths."""
    return _digest(extra, *(e.shash + _ints(e.width) for e in exprs))


def dag_to_state(exprs):
    """Flatten a DAG to a picklable (nodes, roots) pair — iterative, so
    pickling never recurses through a 2^14-step trace chain."""
    order = list(postorder(exprs))
    idx = {id(n): i for i, n in enumerate(order)}
    nodes = [
        (
            n.op,
            tuple(idx[id(a)] for a in n.args),
            n.aux,
            n.width,
            n.nbits,
            n.shash,
            n.aff0,
        )
        for n in order
    ]
    return nodes, [idx[id(e)] for e in exprs]


def dag_from_state(state):
    """Rebuild root Exprs from :func:`dag_to_state` output (shash/aff0 are
    restored verbatim, not recomputed)."""
    nodes, roots = state
    built: list[Expr] = []
    for op, args, aux, width, nbits, shash, aff0 in nodes:
        n = Expr.__new__(Expr)
        n.op = op
        n.args = tuple(built[i] for i in args)
        n.aux = aux
        n.width = width
        n.nbits = nbits
        n.shash = shash
        n.aff0 = aff0
        built.append(n)
    return [built[i] for i in roots]


# --------------------------------------------------------------------------
# coefficient materialization (eager BitVec per node, shared walk)

def materialize_many(exprs, strip_consts: bool = False):
    """Evaluate DAG nodes to eager packed matrices in ONE shared walk.

    Returns a list of (width, W64) uint64 arrays, one per root.  With
    ``strip_consts`` the XOR constants are skipped, yielding the
    input-independent coefficient matrix (structural affine contributions,
    e.g. from OR-with-constant, are kept).  Intermediate results are freed
    as soon as their last consumer is evaluated, so peak memory tracks the
    trace's live working set, not the DAG size.

    Quadratic product nodes (``mulq``) are evaluated in one BATCHED
    ``mul_bits`` call per system instead of one per-row monomial expansion
    each — the reference's per-bit idiom (examples/nlfsr.py:49-57) then
    materializes ~3x faster than row-at-a-time.
    """
    # one DFS builds the postorder, the consumer refcounts, and the
    # flat-mulq classification together (three per-node dict passes fused:
    # ~25% of the walk at NLFSR scale was this bookkeeping).
    # has_mulq[n]: any mulq at-or-below n; flat mulq nodes (no nested mulq
    # in their operands) evaluate as ONE vectorized expansion per system
    # between two passes over the same postorder: pass A evaluates the
    # product-free part of the DAG (which contains every flat-mulq operand
    # by construction), the batch point expands all products at once, pass
    # C evaluates everything downstream.  Single walk, single refcount.
    order: list[Expr] = []
    nconsumers: dict[int, int] = {}
    has_mulq: dict[int, bool] = {}
    flat: list[Expr] = []
    seen: set[int] = set()
    stack = [(r, False) for r in reversed(exprs)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            order.append(node)
            hm = False
            for a in node.args:
                aid = id(a)
                nconsumers[aid] = nconsumers.get(aid, 0) + 1
                hm = hm or has_mulq[aid]
            if node.op == "mulq":
                if not hm:
                    flat.append(node)
                hm = True
            has_mulq[id(node)] = hm
            continue
        nid = id(node)
        if nid in seen:
            continue
        seen.add(nid)
        stack.append((node, True))
        stack.extend((ch, False) for ch in reversed(node.args))
    for r in exprs:
        nconsumers[id(r)] = nconsumers.get(id(r), 0) + 1  # keep the roots
    batched = (
        {id(n) for n in flat} if len(flat) >= _MULQ_MIN_BATCH else set()
    )

    memo: dict[int, BitVec] = {}

    def _consume(n):
        for a in n.args:
            aid = id(a)
            nconsumers[aid] -= 1
            if nconsumers[aid] == 0:
                del memo[aid]

    for n in order:  # pass A: the product-free part of the DAG
        nid = id(n)
        if has_mulq[nid]:
            continue
        memo[nid] = _eval_coeff(
            n, [memo[id(a)] for a in n.args], strip_consts
        )
        _consume(n)

    if batched:  # batch point: one vectorized expansion per system
        by_sys: dict[int, list] = {}
        for n in flat:
            by_sys.setdefault(id(n.aux), []).append(n)
        for group in by_sys.values():
            qsys = group[0].aux
            nw_lin = -(-(1 + qsys._lin_size) // 64)
            a_rows = np.stack(
                [memo[id(n.args[0])].rows[0][:nw_lin] for n in group]
            )
            b_rows = np.stack(
                [memo[id(n.args[1])].rows[0][:nw_lin] for n in group]
            )
            prod_rows = _expand_products(qsys, a_rows, b_rows)
            for k, n in enumerate(group):
                memo[id(n)] = BitVec(prod_rows[k : k + 1], n.nbits)
        for n in flat:
            _consume(n)

    for n in order:  # pass C: everything downstream of a product
        nid = id(n)
        if not has_mulq[nid] or nid in batched:
            continue
        memo[nid] = _eval_coeff(
            n, [memo[id(a)] for a in n.args], strip_consts
        )
        _consume(n)

    return [memo[id(e)].rows for e in exprs]


_MULQ_MIN_BATCH = 8  # below this, per-node numpy row expansion is cheaper


def _expand_products(qsys, a_rows: np.ndarray, b_rows: np.ndarray):
    n = qsys._lin_size
    return qsys.mul_bits(
        BitVec(a_rows, 1 + n), BitVec(b_rows, 1 + n)
    ).rows


def _promote(a: BitVec, b: BitVec):
    """Zero-pad the narrower of two packed BitVecs to a common word count.

    Quadratic traces mix widths by design: linear subgraphs stay at the
    narrow linear-columns-only width, and only ``mulq`` nodes produce
    full-monomial-width rows (quad columns of a linear row are zero, so
    padding is exact)."""
    wa, wb = a.rows.shape[1], b.rows.shape[1]
    if wa == wb:
        return a, b
    if wa < wb:
        return BitVec(_pad_words(a.rows, wb), b.nbits), b
    return a, BitVec(_pad_words(b.rows, wa), a.nbits)


def _pad_words(rows: np.ndarray, w: int) -> np.ndarray:
    # manual zero-extend: np.pad's generic machinery costs ~70us/call and
    # the quadratic XOR tails call this once per traced output bit
    out = np.zeros((rows.shape[0], w), dtype=rows.dtype)
    out[:, : rows.shape[1]] = rows
    return out


def materialize_pending(bvs) -> None:
    """Materialize every not-yet-materialized LazyBitVec among ``bvs`` in
    ONE shared-memo walk (per-item materialization would re-evaluate the
    shared trace prefix per row).  The single helper for every consumer
    that mixes eager and lazy BitVecs (get_eqs_packed, guess sweeps)."""
    pending = [
        bv for bv in bvs if isinstance(bv, LazyBitVec) and bv._rows is None
    ]
    if pending:
        for bv, mat in zip(
            pending, materialize_many([bv._expr for bv in pending])
        ):
            bv._rows = mat


def pad_mats_to_words(mats, nw: int):
    """Zero-extend materialized row blocks to a common word count (quadratic
    traces emit pure-linear rows at the narrow linear-columns width).  The
    single shared helper for every materialize_many consumer."""
    return [m if m.shape[1] == nw else _pad_words(m, nw) for m in mats]


def _eval_coeff(n: Expr, ch: list, strip: bool) -> BitVec:
    op = n.op
    if op == "leaf":
        return n.aux
    if op == "mulq":
        # degree-2 product row (QuadraticSystem.mul_bit): the coefficient
        # columns depend only on the operands' coefficient columns and the
        # struct-affine bit is structA & structB, so the strip-consts
        # invariant extends to quadratic traces unchanged
        qsys = n.aux
        row = qsys._mul_bit_rows(ch[0].rows[0], ch[1].rows[0])
        return BitVec(row[None, :], n.nbits)
    a = ch[0]
    if op == "xor":
        a, b = _promote(a, ch[1])
        return a ^ b
    if op == "xorc":
        if strip:
            return a
        if isinstance(n.aux, Param):
            raise ValueError(
                "cannot materialize a captured trace with unbound Params; "
                "solve through CapturedTrace.solve_*(values)"
            )
        return a ^ n.aux
    if op == "and":
        return a & n.aux
    if op == "orc":
        return a | n.aux
    if op == "rshift":
        return a >> n.aux
    if op == "lshift":
        return a << n.aux
    if op == "lshift_ext":
        return a.lshift_ext(n.aux)
    if op == "rotr":
        return a.rotr(n.aux)
    if op == "rotl":
        return a.rotl(n.aux)
    if op == "sum":
        return a.sum()
    if op == "zeroext":
        return a.zeroext(n.aux)
    if op == "signext":
        return a.signext(n.aux)
    if op == "broadcast":
        return a.broadcast(*n.aux)
    if op == "dup":
        return a.dup(n.aux)
    if op == "concat":
        a, b = _promote(a, ch[1])
        return a.concat(b)
    if op == "slice":
        return a[n.aux[0] : n.aux[1]]
    if op == "take":
        return a[np.asarray(n.aux, dtype=np.int64)]
    if op == "stack":
        wide = max(c.rows.shape[1] for c in ch)
        if any(c.rows.shape[1] != wide for c in ch):
            ref = next(c for c in ch if c.rows.shape[1] == wide)
            ch = [_promote(c, ref)[0] for c in ch]
        return BitVec.stack(ch)
    raise AssertionError(f"unknown op {op}")


# --------------------------------------------------------------------------
# affine column interpreter (one Python int bitmask per node)

def affine_many(exprs, env=None) -> list[int]:
    """The true affine column of each root for THIS instance's constants,
    as an int bitmask over the root's rows (bit i = affine term of bit i).
    Subgraphs with ``aff0`` are pruned (their value is 0 by construction).
    ``env`` binds Param placeholders (captured traces) to this instance's
    constants."""
    memo: dict[int, int] = {}
    seen = set()
    stack = [(r, False) for r in reversed(exprs) if not r.aff0]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            memo[id(node)] = _eval_affine(
                node, [0 if a.aff0 else memo[id(a)] for a in node.args], env
            )
            continue
        if id(node) in seen:
            continue
        seen.add(id(node))
        stack.append((node, True))
        stack.extend(
            (ch, False) for ch in reversed(node.args) if not ch.aff0
        )
    return [0 if e.aff0 else memo[id(e)] for e in exprs]


def _eval_affine(n: Expr, ch: list[int], env=None) -> int:
    op = n.op
    w = n.width
    wmask = (1 << w) - 1
    if op == "leaf":
        # packed bit 0 of every row
        bits = (n.aux.rows[:, 0] & np.uint64(1)).astype(np.uint8)
        return int.from_bytes(
            np.packbits(bits, bitorder="little").tobytes(), "little"
        )
    if op == "mulq":
        return ch[0] & ch[1]
    a = ch[0]
    if op == "xor":
        return a ^ ch[1]
    if op == "xorc":
        c = n.aux.bind(env) if isinstance(n.aux, Param) else n.aux
        return a ^ (c & wmask)
    if op == "and":
        return a & n.aux
    if op == "orc":
        return a | n.aux
    if op == "rshift":
        return a >> n.aux
    if op == "lshift":
        k = n.aux
        aw = n.args[0].width
        return (a & ((1 << max(aw - k, 0)) - 1)) << k
    if op == "lshift_ext":
        return a << n.aux
    if op == "rotr":
        k = n.aux % w
        return ((a >> k) | (a << (w - k))) & wmask if k else a
    if op == "rotl":
        k = n.aux % w
        return ((a << k) | (a >> (w - k))) & wmask if k else a
    if op == "sum":
        return a.bit_count() & 1
    if op == "zeroext":
        return a
    if op == "signext":
        aw = n.args[0].width
        top = (a >> (aw - 1)) & 1
        return a | (((1 << n.aux) - 1) << aw if top else 0)
    if op == "broadcast":
        i, cnt = n.aux
        return ((1 << cnt) - 1) if (a >> i) & 1 else 0
    if op == "dup":
        aw = n.args[0].width
        out = 0
        for k in range(n.aux):
            out |= a << (aw * k)
        return out
    if op == "concat":
        return a | (ch[1] << n.args[0].width)
    if op == "slice":
        lo, hi = n.aux
        return (a >> lo) & ((1 << (hi - lo)) - 1)
    if op == "take":
        out = 0
        for i, j in enumerate(n.aux):
            out |= ((a >> j) & 1) << i
        return out
    if op == "stack":
        out = off = 0
        for c, child in zip(ch, n.args):
            out |= c << off
            off += child.width
        return out
    raise AssertionError(f"unknown op {op}")


# --------------------------------------------------------------------------
# the lazy bitvector

def _mask_hash(width: int, mask: int) -> bytes:
    return _bigint(mask & ((1 << width) - 1))


class LazyBitVec(BitVec):
    """A BitVec that records ops instead of computing them.

    ``rows`` materializes on first touch (and is cached on the instance), so
    every inherited method — ``evaluate``, ``_bits``, pickling, the
    OR-of-two-bitvecs special case — keeps working unchanged.
    """

    __slots__ = ("_expr", "_rows")

    def __init__(self, expr: Expr):
        self._expr = expr
        self._rows = None
        self.nbits = expr.nbits

    @classmethod
    def from_eager(cls, bv: BitVec, structural_name: bytes | None = None):
        """Wrap an eager BitVec as a leaf.  Named leaves (e.g. system
        generators) hash by name; anonymous ones hash by content."""
        if structural_name is None:
            structural_name = _digest(
                np.ascontiguousarray(bv.rows).tobytes(), _ints(bv.nbits)
            )
        expr = _leaf("leaf", bv, len(bv), bv.nbits, structural_name)
        return cls(expr)

    # -- materialization ---------------------------------------------------

    @property
    def rows(self) -> np.ndarray:
        if self._rows is None:
            (self._rows,) = materialize_many([self._expr])
        return self._rows

    def __len__(self) -> int:
        return self._expr.width

    def __repr__(self) -> str:
        return f"LazyBitVec(width={len(self)}, nbits={self.nbits})"

    # -- recorded ops (semantics identical to the eager BitVec) -------------

    def _node(self, op, args, aux, width, hash_aux) -> "LazyBitVec":
        if len(args) == 1:
            nbits = args[0].nbits
        elif args:
            nbits = max(a.nbits for a in args)
        else:
            nbits = self.nbits
        return LazyBitVec(Expr(op, args, aux, width, nbits, hash_aux))

    def _unary(self, op, aux, width, hash_aux=None):
        if hash_aux is None:
            if type(aux) is int:
                hash_aux = _IB[aux] if 0 <= aux < 4096 else _ints(aux)
            else:
                hash_aux = _ints(*aux)
        return self._node(op, (self._expr,), aux, width, hash_aux)

    @staticmethod
    def _as_expr(other: BitVec) -> Expr:
        if isinstance(other, LazyBitVec):
            return other._expr
        return LazyBitVec.from_eager(other)._expr

    def __xor__(self, other):
        w = len(self)
        if isinstance(other, BitVec):
            if len(other) != w:
                raise ValueError(f"BitVec width mismatch: {w} vs {len(other)}")
            oe = self._as_expr(other)
            return self._node("xor", (self._expr, oe), None, w, b"")
        # XOR with a Python int (or a captured-trace Param placeholder):
        # affine-only, excluded from the structural hash either way
        aux = other if isinstance(other, Param) else int(other)
        return self._node("xorc", (self._expr,), aux, w, b"")

    __rxor__ = __xor__
    __pow__ = __xor__

    def __rshift__(self, n: int):
        return self if n == 0 else self._unary("rshift", int(n), len(self))

    def __lshift__(self, n: int):
        if n == 0:
            return self
        return self._unary("lshift", int(n), max(len(self), int(n)))

    def lshift_ext(self, n: int):
        return self._unary("lshift_ext", int(n), len(self) + int(n))

    def __and__(self, mask: int):
        w = len(self)
        mask = int(mask) & ((1 << w) - 1)
        if mask == (1 << w) - 1:
            return self
        return self._node(
            "and", (self._expr,), mask, w, _mask_hash(w, mask)
        )

    __rand__ = __and__

    def __or__(self, mask):
        if isinstance(mask, BitVec):
            # const-overlap OR: rare; materialize (inherited semantics)
            return BitVec.__or__(self, mask)
        w = len(self)
        mask = int(mask) & ((1 << w) - 1)
        return self._node("orc", (self._expr,), mask, w, _mask_hash(w, mask))

    __ror__ = __or__

    def __mod__(self, n: int):
        if n & (n - 1) != 0:
            raise ValueError("modulo non-power-of-2 is not a linear operation")
        return self & (n - 1)

    def rotr(self, n: int):
        return self._unary("rotr", int(n) % len(self), len(self))

    def rotl(self, n: int):
        return self._unary("rotl", int(n) % len(self), len(self))

    def sum(self):
        return self._unary("sum", 0, 1)

    def zeroext(self, n: int):
        return self._unary("zeroext", int(n), len(self) + int(n))

    def signext(self, n: int):
        return self._unary("signext", int(n), len(self) + int(n))

    def broadcast(self, i: int, n: int):
        return self._unary("broadcast", (int(i), int(n)), int(n))

    def dup(self, n: int):
        return self._unary("dup", int(n), len(self) * int(n))

    def concat(self, other: BitVec):
        oe = self._as_expr(other)
        return self._node(
            "concat", (self._expr, oe), None, len(self) + len(other), b""
        )

    def __getitem__(self, key):
        w = len(self)
        if isinstance(key, slice):
            lo, hi, step = key.indices(w)
            if step == 1:
                return self._unary("slice", (lo, hi), max(hi - lo, 0))
            idx = tuple(range(lo, hi, step))
            return self._unary("take", idx, len(idx), _ints(*idx))
        if isinstance(key, (list, np.ndarray)):
            arr = np.asarray(key)
            if arr.dtype == np.bool_:
                arr = np.flatnonzero(arr)
            idx = tuple(int(i) + (w if i < 0 else 0) for i in arr.tolist())
            return self._unary("take", idx, len(idx), _ints(*idx))
        k = int(key)
        if k < 0:
            k += w
        if not 0 <= k < w:
            raise IndexError(f"bit index {key} out of range for width {w}")
        return self._unary("slice", (k, k + 1), 1)

    @classmethod
    def stack(cls, items):
        items = list(items)
        exprs = tuple(cls._as_expr(b) for b in items)
        width = sum(e.width for e in exprs)
        nbits = max(e.nbits for e in exprs)
        return cls(Expr("stack", exprs, None, width, nbits, b""))

"""Tensor Toolbox class surface — thin, immutable, pytree-registered wrappers
over the functional kernel layer.

The reference vendors the full Tensor Toolbox v3.1 class library (SURVEY §2.3:
``@tensor`` 2,974 LoC, ``@sptensor`` 3,732, ``@ktensor`` 2,495, ``@ttensor``
964, ``@tenmat`` 671, ``@sptenmat`` 737, ``@symtensor`` 1,318, ``@symktensor``
1,375, ``@sumtensor`` 517 under
``other_methods/tensor_toolbox-v3.1``). The algorithms and kernels already
live as pure functions in :mod:`tritd_tpu.ops` — this module supplies the
*class* face: operator overloads, methods, and conversions, matching the
MATLAB method files named in each docstring.

Design notes
------------
* Every class is registered as a JAX pytree, so instances flow through
  ``jit`` / ``vmap`` / ``grad`` / ``shard_map`` unchanged; static structure
  (shapes, mode lists) rides in the aux data, arrays are leaves.
* Instances are immutable — all methods return new objects (the MATLAB
  classes are value types too, so semantics match).
* Arithmetic follows the toolbox: ``+ - * /`` are elementwise
  (``plus/minus/times/rdivide.m``; MATLAB's ``mtimes`` on tensors only
  accepts scalars, which Python's ``*`` subsumes), comparisons return
  boolean tensors (``eq/ne/lt/le/gt/ge.m``).
* ``SymTensor`` stores the dense symmetrized array rather than the
  distinct-element compression (deliberate, XLA-friendly — see
  :mod:`tritd_tpu.ops.symmetric`).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .decomp import mttkrp as _dense_mttkrp
from .kruskal import cp_normalize, khatrirao, ktensor_full
from . import sparse as _sp
from . import symmetric as _sym
from . import tenutils as _tu

__all__ = [
    "Tensor",
    "SpTensor",
    "KTensor",
    "TTensor",
    "SymTensor",
    "SymKTensor",
    "SumTensor",
    "TenMat",
    "SpTenMat",
]


def _data_of(other):
    """Unwrap a Tensor/array operand to a raw array (scalar passes through)."""
    if isinstance(other, Tensor):
        return other.data
    return other


@jax.tree_util.register_pytree_node_class
class Tensor:
    """Dense tensor — ``@tensor``. Wraps one ``jnp.ndarray``.

    Methods mirror the ``@tensor`` method files: ``norm.m``, ``innerprod.m``,
    ``ttm.m``, ``ttv.m``, ``ttt.m``, ``ttsv.m``, ``mttkrp.m``, ``nvecs.m``,
    ``collapse.m``, ``contract.m``, ``scale.m``, ``squeeze.m``,
    ``permute.m``, ``reshape.m``, ``symmetrize.m``, ``issymmetric.m``,
    ``tenfun.m``, ``full.m``, ``double.m``, plus the arithmetic /
    comparison / logical operator files.
    """

    def __init__(self, data):
        self.data = jnp.asarray(data)

    # -- pytree
    def tree_flatten(self):
        return (self.data,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.data = children[0]
        return obj

    # -- shape surface (`ndims.m`, `size.m`, `nnz.m`, `isscalar.m`)
    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def nnz(self):
        return jnp.sum(self.data != 0)

    def isscalar(self) -> bool:
        return self.data.ndim == 0

    # -- conversions (`full.m`, `double.m`)
    def full(self) -> "Tensor":
        return self

    def double(self) -> jnp.ndarray:
        return self.data

    def __array__(self, dtype=None):
        import numpy as np

        return np.asarray(self.data, dtype=dtype)

    # -- arithmetic (`plus/minus/times/rdivide/ldivide/power/uminus.m`)
    def __add__(self, other):
        return Tensor(self.data + _data_of(other))

    __radd__ = __add__

    def __sub__(self, other):
        return Tensor(self.data - _data_of(other))

    def __rsub__(self, other):
        return Tensor(_data_of(other) - self.data)

    def __mul__(self, other):
        return Tensor(self.data * _data_of(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Tensor(self.data / _data_of(other))

    def __rtruediv__(self, other):
        return Tensor(_data_of(other) / self.data)

    def __pow__(self, other):
        return Tensor(self.data ** _data_of(other))

    def __neg__(self):
        return Tensor(-self.data)

    def __pos__(self):
        return self

    def __abs__(self):
        return Tensor(jnp.abs(self.data))

    def exp(self):
        return Tensor(jnp.exp(self.data))

    # -- comparisons / logicals (`eq/ne/lt/le/gt/ge/and/or/not/xor.m`)
    def __eq__(self, other):
        return Tensor(self.data == _data_of(other))

    def __ne__(self, other):
        return Tensor(self.data != _data_of(other))

    def __lt__(self, other):
        return Tensor(self.data < _data_of(other))

    def __le__(self, other):
        return Tensor(self.data <= _data_of(other))

    def __gt__(self, other):
        return Tensor(self.data > _data_of(other))

    def __ge__(self, other):
        return Tensor(self.data >= _data_of(other))

    __hash__ = None  # like ndarray: == is elementwise

    def logical_and(self, other):
        return Tensor((self.data != 0) & (_data_of(other) != 0))

    def logical_or(self, other):
        return Tensor((self.data != 0) | (_data_of(other) != 0))

    def logical_not(self):
        return Tensor(self.data == 0)

    def logical_xor(self, other):
        return Tensor((self.data != 0) ^ (_data_of(other) != 0))

    def isequal(self, other) -> jnp.ndarray:
        o = _data_of(other)
        if jnp.shape(o) != self.shape:
            return jnp.asarray(False)
        return jnp.all(self.data == o)

    # -- indexing (`subsref.m`; returns Tensor like X(ranges) does).
    # MATLAB's `end`-style indexing (`@tensor/end.m`: X(end,:,:)) maps to
    # Python's native negative indexing — X[-1] / X[..., -1] — so no
    # separate helper is needed; pinned by test_classes.py.
    def __getitem__(self, idx):
        return Tensor(self.data[idx])

    def find(self):
        """(subs, vals) of nonzero entries — ``@tensor/find.m``. Returns an
        (nnz, ndim) 0-based subscript array + the matching values. NOTE:
        output shape is data-dependent, so call OUTSIDE jit (like the
        toolbox, which is host-side); inside jit use jnp.nonzero with a
        static size argument instead."""
        import numpy as _np

        arr = _np.asarray(self.data)
        subs = _np.argwhere(arr)
        return subs, arr[tuple(subs.T)]

    # -- scalar division forms (`@tensor/mldivide.m`, `mrdivide.m`): the
    # toolbox defines A \ X (scalar left-divide) and X / B (scalar
    # right-divide); the elementwise ldivide/rdivide general forms are
    # covered by __truediv__/__rtruediv__ above.
    def mldivide(self, scalar):
        """scalar \\ X — every element divided by `scalar`."""
        return Tensor(self.data / scalar)

    def mrdivide(self, scalar):
        """X / scalar — alias of __truediv__ for scalar operands."""
        return Tensor(self.data / scalar)

    # -- structure ops (`permute/reshape/squeeze.m`)
    def permute(self, order) -> "Tensor":
        return Tensor(jnp.transpose(self.data, tuple(order)))

    def reshape(self, shape) -> "Tensor":
        return Tensor(self.data.reshape(tuple(shape)))

    def squeeze(self) -> "Tensor":
        return Tensor(jnp.squeeze(self.data))

    # -- numerics
    def norm(self) -> jnp.ndarray:
        """Frobenius norm — ``@tensor/norm.m``."""
        return jnp.linalg.norm(self.data.ravel())

    def innerprod(self, other) -> jnp.ndarray:
        """<X, Y> — ``@tensor/innerprod.m``; accepts any class (the toolbox
        dispatches dense-vs-decomposed to the decomposed class's method)."""
        if isinstance(other, (KTensor, TTensor, SpTensor, SumTensor)):
            return other.innerprod(self)
        return jnp.vdot(self.data.ravel(), _data_of(other).ravel())

    def ttm(self, mats, modes=None, transpose: bool = False) -> "Tensor":
        """Tensor-times-matrix — ``@tensor/ttm.m`` (list or single)."""
        if isinstance(mats, (jnp.ndarray,)) or (
            hasattr(mats, "ndim") and getattr(mats, "ndim", None) == 2
        ):
            mats = [mats]
            modes = [0 if modes is None else int(modes)]
        else:
            mats = list(mats)
            modes = (
                list(range(len(mats)))
                if modes is None
                else [int(m) for m in modes]
            )
        out = self.data
        for m, u in zip(modes, mats):
            out = _tu.ttm(out, jnp.asarray(u), m, transpose=transpose)
        return Tensor(out)

    def ttv(self, vecs, modes=None) -> "Tensor":
        out = _tu.ttv(self.data, vecs, modes)
        return Tensor(out)

    def ttt(self, other, adims=None, bdims=None) -> "Tensor":
        return Tensor(_tu.ttt(self.data, _data_of(other), adims, bdims))

    def ttsv(self, x, keep: int = 1):
        return _sym.ttsv(self.data, x, keep)

    def mttkrp(self, factors, mode: int) -> jnp.ndarray:
        return _dense_mttkrp(self.data, [jnp.asarray(u) for u in factors], mode)

    def mttkrps(self, factors) -> list:
        """All-modes MTTKRP sequence — ``@tensor/mttkrps.m``. The toolbox
        splits the modes to share partial Khatri-Rao contractions; under XLA
        the per-mode einsums already share the input tensor in HBM and fuse
        their transposes, so the N independent calls are the native
        form."""
        us = [jnp.asarray(u) for u in factors]
        return [_dense_mttkrp(self.data, us, n) for n in range(self.ndim)]

    def nvecs(self, mode: int, r: int) -> jnp.ndarray:
        return _tu.nvecs(self.data, mode, r)

    def with_set(self, idx, value) -> "Tensor":
        """Functional subscripted assignment — ``@tensor/subsasgn.m``
        (X(idx) = v). Instances are immutable, so this returns a new Tensor
        with the entries replaced (``jnp.ndarray.at[...].set``)."""
        return Tensor(self.data.at[idx].set(_data_of(value)))

    def collapse(self, dims=None, fun=jnp.sum):
        out = _tu.collapse(self.data, dims, fun)
        return out if jnp.ndim(out) == 0 else Tensor(out)

    def contract(self, i: int, j: int):
        out = _tu.contract(self.data, i, j)
        return out if jnp.ndim(out) == 0 else Tensor(out)

    def scale(self, s, dims) -> "Tensor":
        return Tensor(_tu.scale(self.data, _data_of(s), dims))

    def symmetrize(self) -> "Tensor":
        return Tensor(_sym.symmetrize(self.data))

    def issymmetric(self, tol: float = 1e-6):
        return _sym.is_symmetric(self.data, tol)

    def tenfun(self, fn, *others) -> "Tensor":
        """Apply an elementwise function across tensors — ``tenfun.m``."""
        return Tensor(fn(self.data, *[_data_of(o) for o in others]))

    def mask(self, w) -> jnp.ndarray:
        """Values at the nonzeros of mask W (column vector) — ``mask.m``."""
        wd = _data_of(w)
        return self.data.ravel()[jnp.nonzero(wd.ravel())[0]]

    def to_tenmat(self, row_modes, col_modes=None) -> "TenMat":
        return TenMat.from_tensor(self.data, row_modes, col_modes)

    def __repr__(self):
        return f"Tensor(shape={tuple(self.shape)}, dtype={self.data.dtype})"


@jax.tree_util.register_pytree_node_class
class SpTensor:
    """Sparse COO tensor — ``@sptensor``; wraps the static-nnz functional
    representation of :mod:`tritd_tpu.ops.sparse` (``vals, coords, shape``).
    Duplicate coordinates accumulate, as ``sptensor.m`` documents."""

    def __init__(self, vals, coords, shape):
        self.vals = jnp.asarray(vals)
        self.coords = jnp.asarray(coords)
        self.shape = tuple(int(s) for s in shape)

    def tree_flatten(self):
        return (self.vals, self.coords), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.vals, obj.coords = children
        obj.shape = aux
        return obj

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def nnz(self):
        return self.vals.shape[0]

    # -- conversions (`full.m`, `double.m`)
    def full(self) -> Tensor:
        return Tensor(_sp.sp_full(self.vals, self.coords, self.shape))

    def double(self) -> jnp.ndarray:
        return self.full().data

    # -- arithmetic: value maps that fix 0 stay sparse (`times`-style);
    #    sptensor +- sptensor concatenates (duplicates accumulate).
    def __mul__(self, other):
        if isinstance(other, SpTensor):
            # elementwise product: gather other's dense values at our coords
            dense = other.double()
            return SpTensor(
                self.vals * dense[tuple(self.coords.T)], self.coords, self.shape
            )
        if isinstance(other, (Tensor,)) or hasattr(other, "ndim") and getattr(
            other, "ndim", 0
        ) > 0:
            dense = _data_of(other)
            return SpTensor(
                self.vals * dense[tuple(self.coords.T)], self.coords, self.shape
            )
        return SpTensor(self.vals * other, self.coords, self.shape)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return SpTensor(self.vals / scalar, self.coords, self.shape)

    def __neg__(self):
        return SpTensor(-self.vals, self.coords, self.shape)

    def __abs__(self):
        return SpTensor(jnp.abs(self.vals), self.coords, self.shape)

    def __add__(self, other):
        if isinstance(other, SpTensor):
            if other.shape != self.shape:
                raise ValueError("shape mismatch")
            return SpTensor(
                jnp.concatenate([self.vals, other.vals]),
                jnp.concatenate([self.coords, other.coords]),
                self.shape,
            )
        return Tensor(self.double() + _data_of(other))

    def __sub__(self, other):
        return self + (-other if isinstance(other, SpTensor) else Tensor(-_data_of(other)))

    def __pos__(self):
        return self

    # -- scalar division forms (`@sptensor/mldivide.m`, `mrdivide.m`)
    def mldivide(self, scalar):
        """scalar \\ X — ``@sptensor/mldivide.m`` (scalar left-divide)."""
        return SpTensor(self.vals / scalar, self.coords, self.shape)

    def mrdivide(self, scalar):
        """X / scalar — ``@sptensor/mrdivide.m``."""
        return SpTensor(self.vals / scalar, self.coords, self.shape)

    # -- predicates (`isscalar.m` is always false for sptensor; `isequal.m`)
    def isscalar(self) -> bool:
        return False

    def isequal(self, other) -> jnp.ndarray:
        oshape = getattr(other, "shape", jnp.shape(_data_of(other)))
        if tuple(oshape) != self.shape:
            return jnp.asarray(False)
        od = other.double() if hasattr(other, "double") else jnp.asarray(_data_of(other))
        return jnp.all(self.double() == od)

    # -- comparisons / logicals (`@sptensor/{eq,ne,lt,le,gt,ge,and,or,not,
    # xor}.m`). The toolbox returns an sptensor over the true pattern; we
    # return the dense boolean Tensor (identical after `double`) — a
    # data-dependent nnz cannot be a static XLA shape.
    def _cmp(self, other, op):
        od = other.double() if hasattr(other, "double") else _data_of(other)
        return Tensor(op(self.double(), od))

    def __eq__(self, other):
        return self._cmp(other, lambda a, b: a == b)

    def __ne__(self, other):
        return self._cmp(other, lambda a, b: a != b)

    def __lt__(self, other):
        return self._cmp(other, lambda a, b: a < b)

    def __le__(self, other):
        return self._cmp(other, lambda a, b: a <= b)

    def __gt__(self, other):
        return self._cmp(other, lambda a, b: a > b)

    def __ge__(self, other):
        return self._cmp(other, lambda a, b: a >= b)

    __hash__ = None  # like ndarray: == is elementwise

    def logical_and(self, other):
        return self._cmp(other, lambda a, b: (a != 0) & (b != 0))

    def logical_or(self, other):
        return self._cmp(other, lambda a, b: (a != 0) | (b != 0))

    def logical_xor(self, other):
        return self._cmp(other, lambda a, b: (a != 0) ^ (b != 0))

    def logical_not(self):
        return Tensor(self.double() == 0)

    # -- indexing (`@sptensor/subsref.m`; MATLAB `end` = negative index)
    def __getitem__(self, idx):
        """Single-subscript lookup stays sparse-native (masked sum over the
        stored coordinates); slice/range indexing densifies."""
        if (
            isinstance(idx, tuple)
            and len(idx) == self.ndim
            and all(isinstance(i, (int,)) or getattr(i, "ndim", 1) == 0 for i in idx)
        ):
            want = jnp.asarray([int(i) % self.shape[k] for k, i in enumerate(idx)])
            match = jnp.all(self.coords == want[None, :], axis=1)
            return jnp.sum(jnp.where(match, self.vals, 0))
        return Tensor(self.double()[idx])

    def with_set(self, subs, vals) -> "SpTensor":
        """Functional subscripted assignment — ``@sptensor/subsasgn.m``.
        Replaces (not accumulates) the entries at `subs`. Host-side: nnz
        changes, so call outside jit (the toolbox mutation is host-side
        too)."""
        import numpy as np

        subs = np.atleast_2d(np.asarray(subs))
        vals = np.atleast_1d(np.asarray(vals))
        lin_old = np.asarray(_sp.sp_sub2ind(self.coords, self.shape))
        lin_new = np.asarray(_sp.sp_sub2ind(jnp.asarray(subs), self.shape))
        keep = ~np.isin(lin_old, lin_new)
        return SpTensor(
            jnp.concatenate([jnp.asarray(np.asarray(self.vals)[keep]), jnp.asarray(vals, self.vals.dtype)]),
            jnp.concatenate(
                [jnp.asarray(np.asarray(self.coords)[keep]), jnp.asarray(subs, self.coords.dtype)]
            ),
            self.shape,
        )

    def elemwise(self, fn) -> "SpTensor":
        v, c, s = _sp.sp_elemwise(self.vals, self.coords, self.shape, fn)
        return SpTensor(v, c, s)

    # `@sptensor/elemfun.m` is the toolbox name for the same operation.
    elemfun = elemwise

    def find(self):
        """(subs, vals) of stored entries — ``@sptensor/find.m`` (the stored
        coordinate list IS the answer for a sparse tensor)."""
        return self.coords, self.vals

    def coalesce(self) -> "SpTensor":
        """Merge duplicate coordinates (host-side; not jittable — nnz
        changes)."""
        import numpy as np

        lin = np.asarray(_sp.sp_sub2ind(self.coords, self.shape))
        uniq, inv = np.unique(lin, return_inverse=True)
        vals = jnp.zeros((len(uniq),), self.vals.dtype).at[inv].add(self.vals)
        coords = _sp.sp_ind2sub(jnp.asarray(uniq), self.shape)
        return SpTensor(vals, coords, self.shape)

    # -- numerics
    def norm(self) -> jnp.ndarray:
        return _sp.sp_norm(self.vals, self.coords, self.shape)

    def innerprod(self, other) -> jnp.ndarray:
        if isinstance(other, SpTensor):
            other = other.full()
        return _sp.sp_innerprod(
            self.vals, self.coords, self.shape, _data_of(other)
        )

    def ttv(self, vecs, modes=None) -> Tensor:
        if hasattr(vecs, "ndim") and getattr(vecs, "ndim", None) == 1:
            vecs, modes = [vecs], [0 if modes is None else int(modes)]
        else:
            vecs = list(vecs)
            modes = (
                list(range(len(vecs))) if modes is None else [int(m) for m in modes]
            )
        out = _sp.sp_ttv(self.vals, self.coords, self.shape, vecs, modes)
        return Tensor(out)

    def mttkrp(self, factors, mode: int) -> jnp.ndarray:
        return _sp.sp_mttkrp(self.vals, self.coords, self.shape, factors, mode)

    def _keep_scatter(self, keep, vals):
        """Scatter `vals` (per stored entry) onto the kept modes (sum)."""
        if not keep:
            return jnp.sum(vals)
        kshape = tuple(self.shape[i] for i in keep)
        lin = _sp.sp_sub2ind(self.coords[:, jnp.array(keep)], kshape)
        out = jnp.zeros((math.prod(kshape),), vals.dtype).at[lin].add(vals)
        return Tensor(out.reshape(kshape))

    def collapse(self, dims=None, fun=jnp.sum):
        """``@sptensor/collapse.m``. The sum reducer stays sparse-native
        (one scatter-add of stored values onto the kept modes); any other
        reducer densifies, since implicit zeros participate in it."""
        n = self.ndim
        if dims is None:
            dims = tuple(range(n))
        dims = tuple(int(d) % n for d in dims)
        keep = tuple(i for i in range(n) if i not in dims)
        if fun is jnp.sum:
            return self._keep_scatter(keep, self.vals)
        out = _tu.collapse(self.double(), dims, fun)
        return out if jnp.ndim(out) == 0 else Tensor(out)

    def contract(self, i: int, j: int):
        """Diagonal contraction over equal-sized modes i,j —
        ``@sptensor/contract.m``. Sparse-native: off-diagonal entries mask
        to zero, the rest scatter onto the remaining modes (static nnz)."""
        if self.shape[i] != self.shape[j]:
            raise ValueError("contracted modes must have equal size")
        keep = tuple(k for k in range(self.ndim) if k not in (int(i), int(j)))
        ondiag = self.coords[:, i] == self.coords[:, j]
        return self._keep_scatter(keep, jnp.where(ondiag, self.vals, 0))

    def divide(self, k: "KTensor", epsilon: float = 1e-10) -> "SpTensor":
        """Divide by a nonnegative ktensor at the stored nonzeros only —
        ``@sptensor/divide.m:23-35`` (the cp_apr helper). Never
        materializes the dense ktensor; divide-by-zero is guarded by
        max(value, epsilon) like the reference's min(epsilon, value)
        denominator floor."""
        entries = k.entries_at(self.coords)
        return SpTensor(
            self.vals / jnp.maximum(entries, epsilon), self.coords, self.shape
        )

    def mask(self, w) -> jnp.ndarray:
        """Values of X at the nonzero locations of mask W —
        ``@sptensor/mask.m`` (an sptensor mask keeps its stored order)."""
        if isinstance(w, SpTensor):
            return self.double()[tuple(w.coords.T)]
        wd = w.data if isinstance(w, Tensor) else jnp.asarray(_data_of(w))
        return self.double().ravel()[jnp.nonzero(wd.ravel())[0]]

    def nvecs(self, mode: int, r: int) -> jnp.ndarray:
        """Leading mode-n vectors — ``@sptensor/nvecs.m``. The toolbox
        assembles Xn·Xnᵀ and calls eigs; the Gram is dense either way, so we
        assemble the dense unfolding with one scatter and reuse the dense
        eigh path."""
        return _tu.nvecs(self.double(), mode, r)

    def ones(self) -> "SpTensor":
        """Replace every stored value with 1 — ``@sptensor/ones.m``
        (`spones` semantics on the stored pattern)."""
        return SpTensor(jnp.ones_like(self.vals), self.coords, self.shape)

    spones = ones

    def reshape(self, new_shape) -> "SpTensor":
        """``@sptensor/reshape.m``: remap coordinates through the linear
        index (this package's row-major convention — ``ops/fold.py``
        docstring; the toolbox's is column-major, an index relabeling that
        round-trips identically)."""
        new_shape = tuple(int(s) for s in new_shape)
        if math.prod(new_shape) != math.prod(self.shape):
            raise ValueError("reshape must preserve the element count")
        lin = _sp.sp_sub2ind(self.coords, self.shape)
        return SpTensor(self.vals, _sp.sp_ind2sub(lin, new_shape), new_shape)

    def scale(self, s, dims) -> "SpTensor":
        """Scale along modes `dims` by the dense array S —
        ``@sptensor/scale.m`` (gathers S at the stored coordinates; stays
        sparse)."""
        n = self.ndim
        if isinstance(dims, int):
            dims = (dims,)
        dims = tuple(int(d) % n for d in dims)
        sd = s.data if isinstance(s, Tensor) else jnp.asarray(_data_of(s))
        sd = sd.reshape(tuple(self.shape[d] for d in dims))
        gathered = sd[tuple(self.coords[:, d] for d in dims)]
        return SpTensor(self.vals * gathered, self.coords, self.shape)

    def spmatrix(self) -> jnp.ndarray:
        """2-way sparse → matrix — ``@sptensor/spmatrix.m``. Returns the
        assembled dense matrix: XLA has no CSR GEMM, so the dense form
        IS the native matrix type here."""
        if self.ndim != 2:
            raise ValueError("spmatrix requires a 2-way sptensor")
        return self.double()

    def squeeze(self):
        """Drop singleton modes — ``@sptensor/squeeze.m``."""
        keep = tuple(i for i, s in enumerate(self.shape) if s != 1)
        if not keep:
            return jnp.sum(self.vals)
        if len(keep) == self.ndim:
            return self
        return SpTensor(
            self.vals,
            self.coords[:, jnp.array(keep)],
            tuple(self.shape[i] for i in keep),
        )

    def _ttm_single(self, u: jnp.ndarray, mode: int, transpose: bool) -> jnp.ndarray:
        """One sparse tensor-times-matrix: for every stored entry, its value
        times the matrix column lands in the output mode-`mode` fiber — a
        single (prod(other modes), p) scatter-add, then moveaxis. This is
        the accumarray strategy of ``@sptensor/ttm.m`` recast as one XLA
        scatter instead of a per-fiber loop."""
        u = jnp.asarray(u)
        u = u.T if transpose else u
        p = u.shape[0]
        keep = tuple(i for i in range(self.ndim) if i != mode)
        kshape = tuple(self.shape[i] for i in keep)
        lin = (
            _sp.sp_sub2ind(self.coords[:, jnp.array(keep)], kshape)
            if keep
            else jnp.zeros((self.nnz,), self.coords.dtype)
        )
        contrib = u[:, self.coords[:, mode]] * self.vals[None, :]  # (p, nnz)
        flat = (
            jnp.zeros((math.prod(kshape) if keep else 1, p), self.vals.dtype)
            .at[lin]
            .add(contrib.T)
        )
        return jnp.moveaxis(flat.reshape(kshape + (p,)), -1, mode)

    def ttm(self, mats, modes=None, transpose: bool = False) -> Tensor:
        """Tensor-times-matrix — ``@sptensor/ttm.m``. The first product is
        the sparse scatter-GEMM; the result's mode-`mode` fibers fill in, so
        subsequent modes use the dense kernel (the toolbox likewise returns
        a dense tensor when the result density warrants)."""
        if hasattr(mats, "ndim") and getattr(mats, "ndim", None) == 2:
            mats, modes = [mats], [0 if modes is None else int(modes)]
        else:
            mats = list(mats)
            modes = (
                list(range(len(mats))) if modes is None else [int(m) for m in modes]
            )
        dense = None
        for m, u in zip(modes, mats):
            if dense is None:
                dense = self._ttm_single(u, m, transpose)
            else:
                dense = _tu.ttm(dense, jnp.asarray(u), m, transpose=transpose)
        return Tensor(dense)

    def ttt(self, other, adims=None, bdims=None):
        """Tensor-times-tensor — ``@sptensor/ttt.m``. The outer product of
        two sparse tensors stays sparse-native (coordinate cross-join +
        value outer product); contractions assemble the dense unfoldings
        for one GEMM, mirroring the toolbox's accumarray assembly."""
        if adims is None and bdims is None and isinstance(other, SpTensor):
            na, nb = self.nnz, other.nnz
            vals = (self.vals[:, None] * other.vals[None, :]).ravel()
            ca = jnp.repeat(self.coords, nb, axis=0)
            cb = jnp.tile(other.coords, (na, 1))
            return SpTensor(
                vals, jnp.concatenate([ca, cb], axis=1), self.shape + other.shape
            )
        od = other.double() if hasattr(other, "double") else jnp.asarray(_data_of(other))
        return Tensor(_tu.ttt(self.double(), od, adims, bdims))

    def permute(self, order) -> "SpTensor":
        order = tuple(order)
        return SpTensor(
            self.vals,
            self.coords[:, jnp.array(order)],
            tuple(self.shape[m] for m in order),
        )

    def to_sptenmat(self, row_modes, col_modes=None) -> "SpTenMat":
        vals, (ri, ci), (nr, nc) = _sp.sptenmat(
            self.vals, self.coords, self.shape, row_modes, col_modes
        )
        n = self.ndim
        row_modes = tuple(int(m) for m in row_modes)
        if col_modes is None:
            col_modes = tuple(m for m in range(n) if m not in row_modes)
        return SpTenMat(vals, ri, ci, row_modes, tuple(col_modes), self.shape)

    def __repr__(self):
        return f"SpTensor(shape={self.shape}, nnz={self.nnz})"


@jax.tree_util.register_pytree_node_class
class KTensor:
    """Kruskal tensor — ``@ktensor``: ``(weights λ, factors U_1..U_N)``."""

    def __init__(self, factors, weights=None):
        self.factors = [jnp.asarray(u) for u in factors]
        r = self.factors[0].shape[1]
        self.weights = (
            jnp.ones((r,), self.factors[0].dtype)
            if weights is None
            else jnp.asarray(weights)
        )

    def tree_flatten(self):
        return (self.weights, self.factors), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.weights, obj.factors = children[0], list(children[1])
        return obj

    @property
    def shape(self):
        return tuple(u.shape[0] for u in self.factors)

    @property
    def ndim(self):
        return len(self.factors)

    def ncomponents(self) -> int:
        """``ncomponents.m``."""
        return self.factors[0].shape[1]

    # -- conversions
    def full(self) -> Tensor:
        return Tensor(ktensor_full(self.factors, self.weights))

    def double(self) -> jnp.ndarray:
        return self.full().data

    def tovec(self, lambdaflag: bool = True) -> jnp.ndarray:
        """Stack factors (column-major per factor) into one vector —
        ``tovec.m``."""
        parts = [u.T.ravel() for u in self.factors]
        if lambdaflag:
            parts = [self.weights] + parts
        return jnp.concatenate(parts)

    @classmethod
    def from_vec(cls, x, shape, rank: int, lambdaflag: bool = True):
        """Inverse of :meth:`tovec` (``ktensor.m`` 'fromvector')."""
        x = jnp.asarray(x)
        off = 0
        if lambdaflag:
            weights, off = x[:rank], rank
        else:
            weights = None
        factors = []
        for s in shape:
            factors.append(x[off : off + s * rank].reshape(rank, s).T)
            off += s * rank
        return cls(factors, weights)

    # -- arithmetic (`plus/minus/mtimes/uminus.m`)
    def __add__(self, other: "KTensor") -> "KTensor":
        if not isinstance(other, KTensor):
            return Tensor(self.double() + _data_of(other))
        return KTensor(
            [
                jnp.concatenate([u, v], axis=1)
                for u, v in zip(self.factors, other.factors)
            ],
            jnp.concatenate([self.weights, other.weights]),
        )

    def __sub__(self, other: "KTensor"):
        return self + (-other if isinstance(other, KTensor) else Tensor(-_data_of(other)))

    def __neg__(self) -> "KTensor":
        return KTensor(self.factors, -self.weights)

    def __mul__(self, scalar) -> "KTensor":
        return KTensor(self.factors, self.weights * scalar)

    __rmul__ = __mul__

    # -- numerics
    def norm(self) -> jnp.ndarray:
        return _tu.ktensor_norm(self.weights, self.factors)

    def innerprod(self, other) -> jnp.ndarray:
        if isinstance(other, KTensor):
            return _tu.ktensor_innerprod(
                self.weights, self.factors, (other.weights, other.factors)
            )
        return _tu.ktensor_innerprod(self.weights, self.factors, _data_of(other))

    def mttkrp(self, factors, mode: int) -> jnp.ndarray:
        """``@ktensor/mttkrp.m``: V = U_n diag(λ) ∏_{i≠n} (U_iᵀ V_i) —
        never materializes the dense tensor."""
        r2 = jnp.asarray(factors[0]).shape[1]
        w = self.weights[:, None] * jnp.ones((1, r2), self.weights.dtype)
        for i, v in enumerate(factors):
            if i == mode:
                continue
            w = w * (self.factors[i].T @ jnp.asarray(v))
        return self.factors[mode] @ w

    def normalize(self) -> "KTensor":
        factors, weights = cp_normalize(self.factors, self.weights)
        return KTensor(factors, weights)

    def arrange(self) -> "KTensor":
        w, f = _tu.ktensor_arrange(self.weights, self.factors)
        return KTensor(f, w)

    def fixsigns(self) -> "KTensor":
        w, f = _tu.ktensor_fixsigns(self.weights, self.factors)
        return KTensor(f, w)

    def redistribute(self, mode: int) -> "KTensor":
        """Absorb λ into factor `mode` — ``redistribute.m``."""
        new = list(self.factors)
        new[mode] = new[mode] * self.weights[None, :]
        return KTensor(new, jnp.ones_like(self.weights))

    def score(self, other: "KTensor") -> jnp.ndarray:
        return _tu.ktensor_score(
            self.weights, self.factors, other.weights, other.factors
        )

    def permute(self, order) -> "KTensor":
        return KTensor([self.factors[m] for m in order], self.weights)

    def ttv(self, vecs, modes=None) -> "KTensor | jnp.ndarray":
        """``@ktensor/ttv.m``: contract vectors into λ; remaining modes stay
        Kruskal (scalar when every mode is contracted)."""
        if hasattr(vecs, "ndim") and getattr(vecs, "ndim", None) == 1:
            vecs, modes = [vecs], [0 if modes is None else int(modes)]
        else:
            vecs = list(vecs)
            modes = (
                list(range(len(vecs))) if modes is None else [int(m) for m in modes]
            )
        w = self.weights
        for m, v in zip(modes, vecs):
            w = w * (self.factors[m].T @ jnp.asarray(v))
        rest = [u for i, u in enumerate(self.factors) if i not in set(modes)]
        if not rest:
            return jnp.sum(w)
        return KTensor(rest, w)

    def __pos__(self):
        return self

    def isscalar(self) -> bool:
        return False

    def isequal(self, other) -> bool:
        """Same structure, same λ, same factors — ``@ktensor/isequal.m``
        (structural, not value, equality — two different Kruskal forms of
        the same dense tensor compare unequal, as in the toolbox)."""
        if not isinstance(other, KTensor) or self.shape != other.shape:
            return False
        if self.ncomponents() != other.ncomponents():
            return False
        same = jnp.all(self.weights == other.weights)
        for u, v in zip(self.factors, other.factors):
            same = same & jnp.all(u == v)
        return same

    def issymmetric(self) -> jnp.ndarray:
        """All factor matrices identical — ``@ktensor/issymmetric.m``."""
        if len(set(u.shape for u in self.factors)) != 1:
            return jnp.asarray(False)
        u0 = self.factors[0]
        same = jnp.asarray(True)
        for u in self.factors[1:]:
            same = same & jnp.all(u == u0)
        return same

    def symmetrize(self) -> "KTensor":
        """Symmetric ktensor whose every factor is the average of the
        normalized, sign-aligned factors — ``@ktensor/symmetrize.m:23-52``
        (λ spread evenly first, signs aligned to the first factor so the
        average does not cancel)."""
        if any(u.shape[0] != self.factors[0].shape[0] for u in self.factors):
            raise ValueError("only cubic ktensors can be symmetrized")
        n = self.ndim
        # distribute |lambda| evenly into the factors (normalize(X, 0));
        # the SIGN stays in lambda — a sign spread as sign^(1/n) across the
        # n factors would cancel for even n, and an even-order negative
        # component has no equal-real-factor form with positive weight.
        w_root = jnp.abs(self.weights) ** (1.0 / n)
        factors = [u * w_root[None, :] for u in self.factors]
        u1 = factors[0]
        avg = u1
        for u in factors[1:]:
            sgn = jnp.sign(jnp.sum(u * u1, axis=0))
            sgn = jnp.where(sgn == 0, 1.0, sgn)
            avg = avg + u * sgn[None, :]
        avg = avg / n
        sgn_w = jnp.where(self.weights < 0, -1.0, 1.0).astype(avg.dtype)
        return KTensor([avg] * n, sgn_w)

    def extract(self, idx) -> "KTensor":
        """Sub-ktensor of the selected components — ``@ktensor/extract.m``."""
        idx = jnp.asarray(idx)
        return KTensor([u[:, idx] for u in self.factors], self.weights[idx])

    def tocell(self) -> list:
        """Factor matrices as a list — ``@ktensor/tocell.m``."""
        return list(self.factors)

    def entries_at(self, coords: jnp.ndarray) -> jnp.ndarray:
        """Values of the ktensor at an (m, ndim) coordinate list without
        densifying: Σ_r λ_r ∏_n U_n[i_n, r]. Backs ``@ktensor/mask.m`` and
        ``@sptensor/divide.m``."""
        prod = self.weights[None, :] * jnp.ones(
            (coords.shape[0], 1), self.weights.dtype
        )
        for n, u in enumerate(self.factors):
            prod = prod * u[coords[:, n], :]
        return jnp.sum(prod, axis=1)

    def mask(self, w) -> jnp.ndarray:
        """Values at the nonzeros of mask W — ``@ktensor/mask.m`` (never
        materializes the dense tensor when W is sparse)."""
        if isinstance(w, SpTensor):
            return self.entries_at(w.coords)
        wd = w.data if isinstance(w, Tensor) else jnp.asarray(_data_of(w))
        return self.double().ravel()[jnp.nonzero(wd.ravel())[0]]

    def nvecs(self, mode: int, r: int, flipsign: bool = True) -> jnp.ndarray:
        """Leading mode-n vectors — ``@ktensor/nvecs.m:44-56``: eigh of
        Xn·Xnᵀ = U_n Λ (⊛_{i≠n} U_iᵀU_i) Λ U_nᵀ, assembled from the small
        r×r Grams, never from the dense tensor."""
        g = jnp.ones(
            (self.ncomponents(), self.ncomponents()), self.factors[0].dtype
        )
        for i, u in enumerate(self.factors):
            if i == mode:
                continue
            g = g * (u.T @ u)
        un = self.factors[mode] * self.weights[None, :]
        gram = un @ g @ un.T
        vals, vecs = jnp.linalg.eigh(gram)
        v = vecs[:, -r:][:, ::-1]
        if flipsign:
            sgn = jnp.sign(v[jnp.argmax(jnp.abs(v), axis=0), jnp.arange(r)])
            v = v * jnp.where(sgn == 0, 1.0, sgn)[None, :]
        return v

    def times(self, other):
        """Elementwise product — ``@ktensor/times.m``: densifies the other
        operand's pattern; against an sptensor only the stored entries are
        touched (result sparse), against dense the result is dense."""
        if isinstance(other, SpTensor):
            return SpTensor(
                other.vals * self.entries_at(other.coords), other.coords, other.shape
            )
        od = other.double() if hasattr(other, "double") else jnp.asarray(_data_of(other))
        return Tensor(self.double() * od)

    def ttm(self, mats, modes=None, transpose: bool = False) -> "KTensor":
        """Tensor-times-matrix — ``@ktensor/ttm.m``: applies V to the
        factor of each mode (V·U_n), staying Kruskal."""
        if hasattr(mats, "ndim") and getattr(mats, "ndim", None) == 2:
            mats, modes = [mats], [0 if modes is None else int(modes)]
        else:
            mats = list(mats)
            modes = (
                list(range(len(mats))) if modes is None else [int(m) for m in modes]
            )
        new = list(self.factors)
        for m, v in zip(modes, mats):
            v = jnp.asarray(v)
            new[m] = (v.T if transpose else v) @ new[m]
        return KTensor(new, self.weights)

    def update(self, modes, data) -> "KTensor":
        """Replace λ (mode 0 in toolbox numbering → mode=-1 here) and/or
        whole factors from one stacked vector — ``@ktensor/update.m:33-60``,
        the vector-of-unknowns interface the optimization methods use.
        `modes` uses this package's 0-based factor numbering with -1 for λ."""
        data = jnp.asarray(data)
        if isinstance(modes, int):
            modes = [modes]
        r = self.ncomponents()
        weights = self.weights
        new = list(self.factors)
        off = 0
        for m in modes:
            if m == -1:
                weights = data[off : off + r]
                off += r
            else:
                sz = self.shape[m]
                # same column-major per-factor layout as tovec/from_vec
                new[m] = data[off : off + sz * r].reshape(r, sz).T
                off += sz * r
        return KTensor(new, weights)

    def __repr__(self):
        return f"KTensor(shape={self.shape}, rank={self.ncomponents()})"


@jax.tree_util.register_pytree_node_class
class TTensor:
    """Tucker tensor — ``@ttensor``: ``(core G, factors U_1..U_N)``."""

    def __init__(self, core, factors):
        self.core = jnp.asarray(_data_of(core))
        self.factors = [jnp.asarray(u) for u in factors]

    def tree_flatten(self):
        return (self.core, self.factors), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.core, obj.factors = children[0], list(children[1])
        return obj

    @property
    def shape(self):
        return tuple(u.shape[0] for u in self.factors)

    @property
    def ndim(self):
        return len(self.factors)

    def full(self) -> Tensor:
        return Tensor(_tu.ttensor_full(self.core, self.factors))

    def double(self) -> jnp.ndarray:
        return self.full().data

    def norm(self) -> jnp.ndarray:
        return _tu.ttensor_norm(self.core, self.factors)

    def innerprod(self, other) -> jnp.ndarray:
        """``@ttensor/innerprod.m``: pull the factors onto the dense operand
        (cost Σ r_i · prod n) instead of densifying the Tucker operand."""
        if isinstance(other, TTensor):
            other = other.full()
        small = Tensor(_data_of(other)).ttm(self.factors, transpose=True)
        return jnp.vdot(self.core.ravel(), small.data.ravel())

    def ttm(self, mats, modes=None, transpose: bool = False) -> "TTensor":
        """``@ttensor/ttm.m``: absorb V into the factor of that mode."""
        if hasattr(mats, "ndim") and getattr(mats, "ndim", None) == 2:
            mats, modes = [mats], [0 if modes is None else int(modes)]
        else:
            mats = list(mats)
            modes = (
                list(range(len(mats))) if modes is None else [int(m) for m in modes]
            )
        new = list(self.factors)
        for m, v in zip(modes, mats):
            v = jnp.asarray(v)
            new[m] = (v.T if transpose else v) @ new[m]
        return TTensor(self.core, new)

    def ttv(self, vecs, modes=None):
        """``@ttensor/ttv.m``: contract vᵀU_m into the core; remaining modes
        stay Tucker (scalar when every mode is contracted)."""
        if hasattr(vecs, "ndim") and getattr(vecs, "ndim", None) == 1:
            vecs, modes = [vecs], [0 if modes is None else int(modes)]
        else:
            vecs = list(vecs)
            modes = (
                list(range(len(vecs))) if modes is None else [int(m) for m in modes]
            )
        core = self.core
        # contract highest mode first so earlier axes stay valid
        pairs = sorted(zip(modes, vecs), key=lambda p: -p[0])
        for m, v in pairs:
            core = jnp.tensordot(core, self.factors[m].T @ jnp.asarray(v), axes=([m], [0]))
        rest = [u for i, u in enumerate(self.factors) if i not in set(modes)]
        if not rest:
            return core  # scalar
        return TTensor(core, rest)

    def mttkrp(self, factors, mode: int) -> jnp.ndarray:
        """``@ttensor/mttkrp.m``: fold Uᵢᵀ Vᵢ into the core, MTTKRP the small
        core, then lift through U_n."""
        small = [
            jnp.eye(self.core.shape[i], dtype=self.core.dtype)
            if i == mode
            else self.factors[i].T @ jnp.asarray(factors[i])
            for i in range(self.ndim)
        ]
        w = _dense_mttkrp(self.core, small, mode)
        return self.factors[mode] @ w

    # -- `uminus/uplus/mtimes.m` (scalar scaling lands on the core)
    def __neg__(self) -> "TTensor":
        return TTensor(-self.core, self.factors)

    def __pos__(self):
        return self

    def __mul__(self, scalar) -> "TTensor":
        return TTensor(self.core * scalar, self.factors)

    __rmul__ = __mul__

    def isscalar(self) -> bool:
        return False

    def isequal(self, other) -> bool:
        """Structural equality (same core, same factors) —
        ``@ttensor/isequal.m``."""
        if not isinstance(other, TTensor) or self.shape != other.shape:
            return False
        if self.core.shape != other.core.shape:
            return False
        same = jnp.all(self.core == other.core)
        for u, v in zip(self.factors, other.factors):
            same = same & jnp.all(u == v)
        return same

    def permute(self, order) -> "TTensor":
        """``@ttensor/permute.m``: permute the core and reorder factors."""
        order = tuple(int(m) for m in order)
        return TTensor(
            jnp.transpose(self.core, order), [self.factors[m] for m in order]
        )

    def nvecs(self, mode: int, r: int, flipsign: bool = True) -> jnp.ndarray:
        """Leading mode-n vectors — ``@ttensor/nvecs.m``: the Gram
        Xn·Xnᵀ = U_n [G_(n) (⊗ U_iᵀU_i) G_(n)ᵀ] U_nᵀ is assembled through
        the small core (one ttm over the non-mode Grams + one small GEMM),
        never through the dense tensor."""
        grams = [
            None if i == mode else self.factors[i].T @ self.factors[i]
            for i in range(self.ndim)
        ]
        gcore = self.core
        for i, g in enumerate(grams):
            if g is not None:
                gcore = _tu.ttm(gcore, g, i)
        cn = jnp.moveaxis(self.core, mode, 0).reshape(self.core.shape[mode], -1)
        gn = jnp.moveaxis(gcore, mode, 0).reshape(gcore.shape[mode], -1)
        small = cn @ gn.T
        gram = self.factors[mode] @ small @ self.factors[mode].T
        vals, vecs = jnp.linalg.eigh(gram)
        v = vecs[:, -r:][:, ::-1]
        if flipsign:
            sgn = jnp.sign(v[jnp.argmax(jnp.abs(v), axis=0), jnp.arange(r)])
            v = v * jnp.where(sgn == 0, 1.0, sgn)[None, :]
        return v

    def __getitem__(self, idx):
        """Single-entry lookup — ``@ttensor/subsref.m``: contract the factor
        rows into the core (cost ∏rᵢ, never densifies)."""
        if isinstance(idx, tuple) and len(idx) == self.ndim:
            core = self.core
            for m in range(self.ndim - 1, -1, -1):
                row = self.factors[m][int(idx[m]) % self.shape[m], :]
                core = jnp.tensordot(core, row, axes=([m], [0]))
            return core
        raise TypeError("TTensor indexing requires a full subscript tuple")

    def __repr__(self):
        return f"TTensor(shape={self.shape}, core={tuple(self.core.shape)})"


@jax.tree_util.register_pytree_node_class
class SymTensor:
    """Symmetric tensor — ``@symtensor``. Stores the dense symmetrized array
    (not the distinct-element compression — deliberate, XLA-friendly;
    :mod:`tritd_tpu.ops.symmetric` docstring)."""

    def __init__(self, data, presymmetrized: bool = False):
        data = jnp.asarray(_data_of(data))
        self.data = data if presymmetrized else _sym.symmetrize(data)

    def tree_flatten(self):
        return (self.data,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.data = children[0]
        return obj

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    def full(self) -> Tensor:
        return Tensor(self.data)

    def double(self) -> jnp.ndarray:
        return self.data

    def issymmetric(self, tol: float = 1e-6):
        return _sym.is_symmetric(self.data, tol)

    def ttsv(self, x, keep: int = 1):
        return _sym.ttsv(self.data, x, keep)

    def norm(self) -> jnp.ndarray:
        return jnp.linalg.norm(self.data.ravel())

    def indices(self):
        """Distinct (sorted, non-decreasing) index tuples — the monomial
        list ``@symtensor/indices.m`` enumerates; a symmetric tensor is
        determined by its values there. Host-side (combinatorial count)."""
        import itertools

        import numpy as np

        n, m = (self.shape[0] if self.ndim else 0), self.ndim
        return np.array(
            list(itertools.combinations_with_replacement(range(n), m)),
            dtype=np.int64,
        ).reshape(-1, m)

    def vals(self) -> jnp.ndarray:
        """Values at :meth:`indices` — the distinct-element vector the
        toolbox's compressed ``@symtensor`` representation stores."""
        subs = self.indices()
        return self.data[tuple(subs.T)]

    # -- elementwise surface (`@symtensor/{plus,minus,times,rdivide,ldivide,
    # power,mtimes(scalar),mldivide,mrdivide,uminus,uplus,tenfun}.m` and the
    # comparison/logical files): elementwise maps preserve symmetry, so each
    # returns a SymTensor over the mapped data without re-symmetrizing.
    def _sym_of(self, other):
        return other.data if isinstance(other, (SymTensor, Tensor)) else _data_of(other)

    def tenfun(self, fn, *others) -> "SymTensor":
        return SymTensor(
            fn(self.data, *[self._sym_of(o) for o in others]), presymmetrized=True
        )

    def __add__(self, other):
        return self.tenfun(lambda a: a + self._sym_of(other))

    __radd__ = __add__

    def __sub__(self, other):
        return self.tenfun(lambda a: a - self._sym_of(other))

    def __rsub__(self, other):
        return self.tenfun(lambda a: self._sym_of(other) - a)

    def __mul__(self, other):
        return self.tenfun(lambda a: a * self._sym_of(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.tenfun(lambda a: a / self._sym_of(other))

    def __rtruediv__(self, other):
        return self.tenfun(lambda a: self._sym_of(other) / a)

    def __pow__(self, other):
        return self.tenfun(lambda a: a ** self._sym_of(other))

    def __neg__(self):
        return self.tenfun(lambda a: -a)

    def __pos__(self):
        return self

    def mldivide(self, scalar):
        return self.tenfun(lambda a: a / scalar)

    def mrdivide(self, scalar):
        return self.tenfun(lambda a: a / scalar)

    def __eq__(self, other):
        return self.tenfun(lambda a: a == self._sym_of(other))

    def __ne__(self, other):
        return self.tenfun(lambda a: a != self._sym_of(other))

    def __lt__(self, other):
        return self.tenfun(lambda a: a < self._sym_of(other))

    def __le__(self, other):
        return self.tenfun(lambda a: a <= self._sym_of(other))

    def __gt__(self, other):
        return self.tenfun(lambda a: a > self._sym_of(other))

    def __ge__(self, other):
        return self.tenfun(lambda a: a >= self._sym_of(other))

    __hash__ = None  # like ndarray: == is elementwise

    def logical_and(self, other):
        return self.tenfun(lambda a: (a != 0) & (self._sym_of(other) != 0))

    def logical_or(self, other):
        return self.tenfun(lambda a: (a != 0) | (self._sym_of(other) != 0))

    def logical_not(self):
        return self.tenfun(lambda a: a == 0)

    def logical_xor(self, other):
        return self.tenfun(lambda a: (a != 0) ^ (self._sym_of(other) != 0))

    def isequal(self, other) -> jnp.ndarray:
        od = self._sym_of(other)
        if jnp.shape(od) != self.shape:
            return jnp.asarray(False)
        return jnp.all(self.data == od)

    def isscalar(self) -> bool:
        return self.data.ndim == 0

    def __getitem__(self, idx):
        """``@symtensor/subsref.m`` — index into the (dense) data."""
        return self.data[idx]

    def with_set(self, idx, value) -> "SymTensor":
        """Functional ``@symtensor/subsasgn.m``: assigning one distinct
        element writes every symmetric copy, so the invariant survives —
        here, the value is set at all permutations of the subscript."""
        import itertools

        data = self.data
        for perm in set(itertools.permutations(tuple(int(i) for i in idx))):
            data = data.at[perm].set(value)
        return SymTensor(data, presymmetrized=True)

    def __repr__(self):
        return f"SymTensor(order={self.ndim}, n={self.shape[0] if self.ndim else 0})"


@jax.tree_util.register_pytree_node_class
class SymKTensor:
    """Symmetric Kruskal tensor — ``@symktensor``: Σ_r λ_r u_r^{⊗m}."""

    def __init__(self, weights, u, order: int):
        self.weights = jnp.asarray(weights)
        self.u = jnp.asarray(u)
        self.order = int(order)

    def tree_flatten(self):
        return (self.weights, self.u), self.order

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.weights, obj.u = children
        obj.order = aux
        return obj

    @property
    def shape(self):
        return (self.u.shape[0],) * self.order

    def full(self) -> SymTensor:
        return SymTensor(
            _sym.symktensor_full(self.weights, self.u, self.order),
            presymmetrized=True,
        )

    def double(self) -> jnp.ndarray:
        return self.full().data

    def norm(self) -> jnp.ndarray:
        g = (self.u.T @ self.u) ** self.order
        q = self.weights @ g @ self.weights
        return jnp.sqrt(jnp.maximum(q, 0.0))

    @property
    def ndim(self):
        return self.order

    def ncomponents(self) -> int:
        """``@symktensor/ncomponents.m``."""
        return self.u.shape[1]

    def isscalar(self) -> bool:
        return False

    def issymmetric(self) -> bool:
        """``@symktensor/issymmetric.m`` — true by construction."""
        return True

    def isequal(self, other) -> jnp.ndarray:
        if (
            not isinstance(other, SymKTensor)
            or other.order != self.order
            or other.u.shape != self.u.shape
        ):
            return jnp.asarray(False)
        return jnp.all(self.weights == other.weights) & jnp.all(self.u == other.u)

    def __mul__(self, scalar) -> "SymKTensor":
        return SymKTensor(self.weights * scalar, self.u, self.order)

    __rmul__ = __mul__

    def __neg__(self) -> "SymKTensor":
        return SymKTensor(-self.weights, self.u, self.order)

    def __pos__(self):
        return self

    def normalize(self) -> "SymKTensor":
        """Unit-normalize the columns of U, absorbing the norms into λ —
        ``@symktensor/normalize.m`` (norm^m per component; odd orders flip
        the column sign to keep λ's sign convention)."""
        nrm = jnp.linalg.norm(self.u, axis=0)
        safe = jnp.where(nrm == 0, 1.0, nrm)
        return SymKTensor(self.weights * safe**self.order, self.u / safe[None, :], self.order)

    def arrange(self) -> "SymKTensor":
        """Normalize, then sort components by |λ| descending —
        ``@symktensor/arrange.m``."""
        k = self.normalize()
        order_idx = jnp.argsort(-jnp.abs(k.weights))
        return SymKTensor(k.weights[order_idx], k.u[:, order_idx], k.order)

    def permute(self, order) -> "SymKTensor":
        """``@symktensor/permute.m`` — any mode permutation of a symmetric
        tensor is itself."""
        if len(tuple(order)) != self.order:
            raise ValueError("permutation length must equal the order")
        return self

    def entry(self, idx) -> jnp.ndarray:
        """One entry Σ_r λ_r ∏_j U[i_j, r] — ``@symktensor/entry.m``."""
        idx = jnp.asarray(idx)
        prod = self.weights
        for j in range(self.order):
            prod = prod * self.u[idx[j], :]
        return jnp.sum(prod)

    def tovec(self, lambdaflag: bool = True) -> jnp.ndarray:
        """[λ; vec(U)] — ``@symktensor/tovec.m``."""
        parts = [self.u.T.ravel()]
        if lambdaflag:
            parts = [self.weights] + parts
        return jnp.concatenate(parts)

    @classmethod
    def from_vec(cls, x, n: int, rank: int, order: int, lambdaflag: bool = True):
        """Inverse of :meth:`tovec` (``symktensor.m`` 'fromvector')."""
        x = jnp.asarray(x)
        off = rank if lambdaflag else 0
        weights = x[:rank] if lambdaflag else jnp.ones((rank,), x.dtype)
        u = x[off : off + n * rank].reshape(rank, n).T
        return cls(weights, u, order)

    def score(self, other: "SymKTensor") -> jnp.ndarray:
        """Similarity score via the ktensor congruence product —
        ``@symktensor/score.m`` (delegates to the Kruskal score on the
        order-m repeated factors)."""
        return _tu.ktensor_score(
            self.weights,
            [self.u] * self.order,
            other.weights,
            [other.u] * other.order,
        )

    def fg_setup(self, a) -> dict:
        """Precomputation for :meth:`fg` — ``@symktensor/fg_setup.m`` (fast
        path): caches ‖A‖², the order m, and the symmetric data array."""
        ad = a.data if isinstance(a, (SymTensor, Tensor)) else jnp.asarray(_data_of(a))
        return {
            "a": ad,
            "m": self.order,
            "norm_a_sqr": jnp.vdot(ad.ravel(), ad.ravel()),
        }

    def fg(self, data: dict):
        """Objective ‖A − full(M)‖² and its gradient for the symmetric
        Kruskal model — ``@symktensor/fg.m:60-76`` (fast path):

            F  = ‖A‖² − 2 λ·z + λᵀ (UᵀU)^{∘m} λ,   z_p = A·x_p^m
            Gλ = −2 z + 2 (UᵀU)^{∘m} λ
            GU = −2m·Y·diag(λ) + 2m·U·diag(λ)(UᵀU)^{∘(m−1)}diag(λ)

        with Y[:,p] = ttsv(A, x_p) = A x_p^{m−1} (vmapped over components).
        Returns ``(f, g)`` with g = [Gλ; vec(GU)] matching :meth:`tovec`.
        Everything is jit/grad-compatible — this is the fmincon-objective
        surface that cp_sym consumes (:mod:`tritd_tpu.ops.symmetric`)."""
        a, m = data["a"], data["m"]
        lam, u = self.weights, self.u
        utu = u.T @ u
        utu_m1 = utu ** (m - 1)
        utu_m = utu_m1 * utu
        y = jax.vmap(lambda col: _sym.ttsv(a, col, keep=1), in_axes=1, out_axes=1)(u)
        z = jnp.sum(u * y, axis=0)
        f = data["norm_a_sqr"] - 2.0 * jnp.dot(lam, z) + lam @ utu_m @ lam
        g_lam = -2.0 * z + 2.0 * (utu_m @ lam)
        g_u = -2.0 * m * y * lam[None, :] + 2.0 * m * (
            u * lam[None, :] @ utu_m1 * lam[None, :]
        )
        return f, jnp.concatenate([g_lam, g_u.T.ravel()])

    def __repr__(self):
        return f"SymKTensor(n={self.u.shape[0]}, rank={self.u.shape[1]}, m={self.order})"


@jax.tree_util.register_pytree_node_class
class SumTensor:
    """Lazy sum of tensors of any class — ``@sumtensor``. Parts densify
    only on ``full``; ``innerprod`` distributes over the parts
    (``@sumtensor/innerprod.m``)."""

    def __init__(self, parts):
        self.parts = [
            p if isinstance(p, (Tensor, SpTensor, KTensor, TTensor)) else Tensor(p)
            for p in parts
        ]

    def tree_flatten(self):
        return (self.parts,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.parts = list(children[0])
        return obj

    @property
    def shape(self):
        return self.parts[0].shape

    @property
    def ndim(self):
        return len(self.shape)

    def __add__(self, other) -> "SumTensor":
        if isinstance(other, SumTensor):
            return SumTensor(self.parts + other.parts)
        return SumTensor(self.parts + [other])

    def full(self) -> Tensor:
        return Tensor(_tu.sumtensor_full([p.double() for p in self.parts]))

    def double(self) -> jnp.ndarray:
        return self.full().data

    def innerprod(self, other) -> jnp.ndarray:
        return sum(p.innerprod(other) for p in self.parts)

    def norm(self) -> jnp.ndarray:
        return self.full().norm()

    def isscalar(self) -> bool:
        return False

    def __pos__(self):
        return self

    def __neg__(self) -> "SumTensor":
        return SumTensor([-p for p in self.parts])

    def mttkrp(self, factors, mode: int) -> jnp.ndarray:
        """``@sumtensor/mttkrp.m``: MTTKRP distributes over the sum, so each
        part uses its own structure-exploiting method."""
        return sum(p.mttkrp(factors, mode) for p in self.parts)

    def ttv(self, vecs, modes=None) -> jnp.ndarray:
        """``@sumtensor/ttv.m``: contract each part (each by its own class
        method) and add the densified results."""
        outs = []
        for p in self.parts:
            o = p.ttv(vecs, modes) if modes is not None else p.ttv(vecs)
            outs.append(o.double() if hasattr(o, "double") else jnp.asarray(o))
        return sum(outs[1:], outs[0])

    def __repr__(self):
        return f"SumTensor({len(self.parts)} parts, shape={self.shape})"


@jax.tree_util.register_pytree_node_class
class TenMat:
    """Tensor-as-matrix — ``@tenmat``: a matricized view that remembers the
    original shape and the row/column mode split, so it converts back."""

    def __init__(self, data, row_modes, col_modes, tshape):
        self.data = jnp.asarray(data)
        self.row_modes = tuple(int(m) for m in row_modes)
        self.col_modes = tuple(int(m) for m in col_modes)
        self.tshape = tuple(int(s) for s in tshape)

    @classmethod
    def from_tensor(cls, x, row_modes, col_modes=None) -> "TenMat":
        x = jnp.asarray(_data_of(x))
        n = x.ndim
        row_modes = (
            (row_modes,) if isinstance(row_modes, int) else tuple(row_modes)
        )
        if col_modes is None:
            col_modes = tuple(m for m in range(n) if m not in row_modes)
        else:
            col_modes = (
                (col_modes,) if isinstance(col_modes, int) else tuple(col_modes)
            )
        from .kruskal import tenmat as _tenmat_fn

        return cls(_tenmat_fn(x, row_modes, col_modes), row_modes, col_modes, x.shape)

    def tree_flatten(self):
        return (self.data,), (self.row_modes, self.col_modes, self.tshape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.data = children[0]
        obj.row_modes, obj.col_modes, obj.tshape = aux
        return obj

    @property
    def shape(self):
        return self.data.shape

    def tsize(self):
        """Original tensor shape — ``tsize.m``."""
        return self.tshape

    def double(self) -> jnp.ndarray:
        return self.data

    def to_tensor(self) -> Tensor:
        """Invert the matricization (inverse of :meth:`from_tensor`)."""
        perm = self.row_modes + self.col_modes
        shape_p = tuple(self.tshape[m] for m in perm)
        inv = [0] * len(perm)
        for pos, m in enumerate(perm):
            inv[m] = pos
        return Tensor(jnp.transpose(self.data.reshape(shape_p), inv))

    @property
    def T(self) -> "TenMat":
        """``ctranspose.m``: swap the row/column mode split."""
        return TenMat(self.data.T, self.col_modes, self.row_modes, self.tshape)

    def norm(self) -> jnp.ndarray:
        return jnp.linalg.norm(self.data.ravel())

    def __add__(self, other):
        return TenMat(
            self.data + (other.data if isinstance(other, TenMat) else other),
            self.row_modes,
            self.col_modes,
            self.tshape,
        )

    def __sub__(self, other):
        return TenMat(
            self.data - (other.data if isinstance(other, TenMat) else other),
            self.row_modes,
            self.col_modes,
            self.tshape,
        )

    def __neg__(self):
        return TenMat(-self.data, self.row_modes, self.col_modes, self.tshape)

    def __mul__(self, other):
        """``@tenmat/mtimes.m``: scalar scaling, or matrix product whose
        result tensor has A's row modes then B's column modes."""
        if not isinstance(other, TenMat):
            return TenMat(
                self.data * other, self.row_modes, self.col_modes, self.tshape
            )
        tsiz = tuple(self.tshape[m] for m in self.row_modes) + tuple(
            other.tshape[m] for m in other.col_modes
        )
        nr = len(self.row_modes)
        return TenMat(
            self.data @ other.data,
            tuple(range(nr)),
            tuple(range(nr, len(tsiz))),
            tsiz,
        )

    __rmul__ = __mul__

    def __pos__(self):
        return self

    def __getitem__(self, idx):
        """``@tenmat/subsref.m`` — matrix indexing on the data."""
        return self.data[idx]

    def with_set(self, idx, value) -> "TenMat":
        """Functional subscripted assignment — ``@tenmat/subsasgn.m``."""
        return TenMat(
            self.data.at[idx].set(_data_of(value)),
            self.row_modes,
            self.col_modes,
            self.tshape,
        )

    def __repr__(self):
        return (
            f"TenMat(shape={tuple(self.shape)}, rows={self.row_modes}, "
            f"cols={self.col_modes}, tshape={self.tshape})"
        )


@jax.tree_util.register_pytree_node_class
class SpTenMat:
    """Sparse tensor-as-matrix — ``@sptenmat``: COO matricization keeping
    the mode split and original shape for round-trip."""

    def __init__(self, vals, row_idx, col_idx, row_modes, col_modes, tshape):
        self.vals = jnp.asarray(vals)
        self.row_idx = jnp.asarray(row_idx)
        self.col_idx = jnp.asarray(col_idx)
        self.row_modes = tuple(int(m) for m in row_modes)
        self.col_modes = tuple(int(m) for m in col_modes)
        self.tshape = tuple(int(s) for s in tshape)

    def tree_flatten(self):
        return (self.vals, self.row_idx, self.col_idx), (
            self.row_modes,
            self.col_modes,
            self.tshape,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.vals, obj.row_idx, obj.col_idx = children
        obj.row_modes, obj.col_modes, obj.tshape = aux
        return obj

    @property
    def shape(self):
        nr = 1
        for m in self.row_modes:
            nr *= self.tshape[m]
        nc = 1
        for m in self.col_modes:
            nc *= self.tshape[m]
        return (nr, nc)

    @property
    def nnz(self):
        return self.vals.shape[0]

    def double(self) -> jnp.ndarray:
        """Dense matrix — ``@sptenmat/double.m`` (duplicates accumulate)."""
        out = jnp.zeros(self.shape, self.vals.dtype)
        return out.at[self.row_idx, self.col_idx].add(self.vals)

    def to_sptensor(self) -> SpTensor:
        """Invert the matricization back to COO tensor coordinates."""
        row_shape = tuple(self.tshape[m] for m in self.row_modes)
        col_shape = tuple(self.tshape[m] for m in self.col_modes)
        subs = jnp.zeros(
            (self.vals.shape[0], len(self.tshape)), self.row_idx.dtype
        )
        if self.row_modes:
            rsub = _sp.sp_ind2sub(self.row_idx, row_shape)
            subs = subs.at[:, jnp.array(self.row_modes)].set(rsub)
        if self.col_modes:
            csub = _sp.sp_ind2sub(self.col_idx, col_shape)
            subs = subs.at[:, jnp.array(self.col_modes)].set(csub)
        return SpTensor(self.vals, subs, self.tshape)

    def tsize(self):
        """Original tensor shape — ``@sptenmat/tsize.m``."""
        return self.tshape

    def full(self) -> TenMat:
        """Densify to a tenmat — ``@sptenmat/full.m``."""
        return TenMat(self.double(), self.row_modes, self.col_modes, self.tshape)

    def norm(self) -> jnp.ndarray:
        """Frobenius norm — ``@sptenmat/norm.m`` (duplicates accumulate, so
        the norm is taken on the assembled matrix, not the raw value list)."""
        return jnp.linalg.norm(self.double().ravel())

    def __neg__(self) -> "SpTenMat":
        return SpTenMat(
            -self.vals,
            self.row_idx,
            self.col_idx,
            self.row_modes,
            self.col_modes,
            self.tshape,
        )

    def __pos__(self):
        return self

    def aatx(self, x: jnp.ndarray) -> jnp.ndarray:
        """Compute A·Aᵀ·x without assembling A —
        ``@sptenmat/aatx.m:25-35``: t = Aᵀx and y = A·t as two scatter/gather
        passes over the stored (row, col, val) triples. This is the
        matrix-free operator the toolbox feeds to eigs; here it is jittable
        and O(nnz)."""
        x = jnp.asarray(x)
        nr, nc = self.shape
        t = (
            jnp.zeros((nc,), self.vals.dtype)
            .at[self.col_idx]
            .add(self.vals * x[self.row_idx])
        )
        return (
            jnp.zeros((nr,), self.vals.dtype)
            .at[self.row_idx]
            .add(self.vals * t[self.col_idx])
        )

    def __repr__(self):
        return f"SpTenMat(shape={self.shape}, nnz={self.nnz})"

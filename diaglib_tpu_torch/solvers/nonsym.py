"""Two-sided Davidson for real nonsymmetric matrices (port of
``diaglib_tpu/solvers/nonsym.py``).

One-sided Davidson passes (right with A, left with A^T) driven through a
``side`` selector: 'r', 'l', or 's'/'c' (both, consecutively: a right
pass, then a left pass seeded from the right eigenvectors), finished by a
pairing-preserving biorthonormalization of (evec_l, evec_r).

All O(n) work (matvecs, Gram matrices, Ritz vectors, residuals,
orthogonalization) runs on the tensors' device.  The small nonsymmetric
reduced eigenproblem is solved by one of two drivers, each followed by the
reference's two serial post-processing steps:

* ``sort_eigenpairs``: ascending selection sort on the real parts, complex
  pairs (|wi| > 1e-12) parked at the tail.  The targeted roots are the
  lowest real eigenvalues;
* root homing: overlaps of the previous and current reduced eigenvectors
  build a max-overlap permutation with tie-breaking fallbacks (the
  reference's intended logic, with correctly shaped arrays).

``driver="host"`` (and "auto", "jit") runs LAPACK ``dgeev`` in float64 on
the host, the sort and the homing in numpy; the reduced matrix and its
eigenvectors cross to the host each iteration.  ``driver="device"`` runs
the Eberlein norm-reducing Jacobi (``utils/eberlein.py``) with the
reference's adaptive off-norm target and the sort and homing as tensor
ops, so the reduced matrix and its eigenvectors stay on the operands'
device.  Both solve the leading ``ldu x ldu`` block (the reference's
prefix buckets are not carried).

A pass has the reference's loop shape: one fixed-shape state (the
reference's ``_NonsymState``, with the same fixed ``(lda_pad, n)``
buffers and every count a 0-d tensor on the device) and an iteration in
steps that read nothing back (:class:`_NonsymIteration`, the reference's
``step_pre`` / ``step_post``), with the reduced solve between them, as
the reference's loop reaches the host dgeev through a callback.  On
unsharded CUDA tensors each step is captured once a pass as a CUDA graph
and replayed (``utils/graphs.py``); the host reads the device twice an
iteration, the Gram matrix for dgeev and the packed flags after the last
step.  A ``sharding=`` run over an NCCL group is captured the same way on
every rank, its collectives inside the graphs (every rank reads the same
all-reduced Gram matrix); CPU tensors and gloo groups call the same
steps directly, with the ortho loops reading their predicates;
``driver="device"`` runs the same steps with the Eberlein solve between
them.

Sharded (``sharding=`` a :class:`~diaglib_tpu_torch.parallel.VectorSharding`
over n): every (k, n) block is the rank's column shard, ``n`` in the rms
is the global length, and the Gram products, norms and maxima are
all-reduced (``utils.mm.mm_sharding``), so every rank solves the same
reduced matrix by the same route and takes the same branch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch

from ..ortho.core import _ortho_cd, _ortho_vs_x, ortho_cd
from ..reporting import inflight_progress
from ..types import NonsymResult, SolverOptions
from ..utils.eberlein import eberlein_eig
from ..utils.graphs import StepLoop, StepState, _budgets, _route
from ..utils.guess import check_guess
from ..utils.masking import gather_rows, prefix_lock, prefix_mask, scatter_rows
from ..utils.mm import (
    amax_n,
    global_n,
    mm_sharding,
    mmT,
    mTm,
    norm_n,
    routing_for,
)

__all__ = ["nonsym", "nonsym_pass", "NonsymPassResult", "nonsym_seed_left",
           "nonsym_finalize"]

_TOL_IM = 1.0e-12
_DRIVERS = ("auto", "jit", "host", "device")


def _host_reduced_eig(a_red, ldu, n_sort, do_homing, copy_r, copy_l, n_max,
                      out_dtype=np.float64):
    """dgeev + sort + root homing on the host (numpy), static shapes.

    a_red: (L, L) with the leading ldu x ldu block valid (G[i,j] = s_i.A s_j).
    Returns wr (L,), vr (L, L), vl (L, L), found_im flag; columns sorted
    ascending by real part over the leading ``n_sort`` slots with complex
    pairs parked at the tail of the valid block, then permuted by maximum
    overlap with the previous reduced eigenvectors (copy_r/copy_l, zero
    padded (L, 2*n_max)).
    """
    import scipy.linalg

    L = a_red.shape[0]
    ldu = int(ldu)
    n_sort = min(int(n_sort), ldu)
    m2 = 2 * n_max
    a = np.asarray(a_red[:ldu, :ldu], dtype=np.float64)
    wr_s, wi_s, vl_s, vr_s, info = scipy.linalg.lapack.dgeev(
        a, compute_vl=1, compute_vr=1
    )
    if info != 0:  # pragma: no cover - matches the reference's hard stop
        raise RuntimeError(f"dgeev failed, info={info}")
    wr = wr_s.copy()
    wi = wi_s.copy()
    vr = vr_s.copy()
    vl = vl_s.copy()

    def swap(i, j):
        if i == j:
            return
        wr[[i, j]] = wr[[j, i]]
        wi[[i, j]] = wi[[j, i]]
        vr[:, [i, j]] = vr[:, [j, i]]
        vl[:, [i, j]] = vl[:, [j, i]]

    # selection sort with complex parking (sort_eigenpairs semantics)
    mask = np.ones(ldu, dtype=bool)
    for i in range(n_sort):
        cand = np.where(mask, wr, np.inf)
        idx = int(np.argmin(cand))
        if abs(wi[idx]) > _TOL_IM:
            fin = ldu - 1
            while fin >= 0 and not mask[fin]:
                fin -= 1
            mask[fin] = False
            swap(fin, idx)
            cand = np.where(mask, wr, np.inf)
            idx = int(np.argmin(cand))
        mask[i] = False
        swap(i, idx)

    found_im = bool(np.any(np.abs(wi[:n_max]) > _TOL_IM))

    if do_homing:
        vr_pad = np.zeros((ldu, m2))
        vl_pad = np.zeros((ldu, m2))
        ncols = min(m2, ldu)
        vr_pad[:, :ncols] = vr[:, :ncols]
        vl_pad[:, :ncols] = vl[:, :ncols]
        ov_r = np.asarray(copy_r)[:ldu, :].T @ vr_pad  # (m2, m2)
        ov_l = np.asarray(copy_l)[:ldu, :].T @ vl_pad

        def pick(ov):
            first_idx = np.zeros(n_max, dtype=int)
            first_val = np.zeros(n_max)
            second_idx = np.zeros(n_max, dtype=int)
            second_val = np.zeros(n_max)
            moved = False
            for j in range(n_max):
                col = np.abs(ov[:, j])
                k1 = int(np.argmax(col))
                first_idx[j], first_val[j] = k1, ov[k1, j]
                if k1 != j:
                    moved = True
                col2 = col.copy()
                col2[k1] = -np.inf
                k2 = int(np.argmax(col2))
                second_idx[j], second_val[j] = k2, ov[k2, j]
            return first_idx, first_val, second_idx, second_val, moved

        idx_r, val_r, idx2_r, val2_r, mv_r = pick(ov_r)
        idx_l, val_l, _, _, mv_l = pick(ov_l)
        found_er = mv_r or mv_l

        def has_double(idx):
            return len(np.unique(idx)) != len(idx)

        double_r, double_l = has_double(idx_r), has_double(idx_l)
        if double_r and not double_l:
            idx_r = idx_l.copy()
        elif double_l and not double_r:
            idx_l = idx_r.copy()
        elif double_r and double_l:
            # resolve collisions on the right side via second-best overlaps
            for j in range(n_max):
                for k in range(n_max):
                    if k != j and idx_r[j] == idx_r[k]:
                        if val2_r[j] > val2_r[k]:
                            idx_r[j] = idx2_r[j]
                        else:
                            idx_r[k] = idx2_r[k]
            if has_double(idx_r):
                idx_r = np.arange(n_max)
                idx_l = np.arange(n_max)
            else:
                idx_l = idx_r.copy()

        if np.any(idx_r != idx_l):
            if np.sum(val_r) > np.sum(val_l):
                idx_l = idx_r.copy()
            else:
                idx_r = idx_l.copy()

        if found_er:
            valid = idx_r < ldu
            perm = np.where(valid, idx_r, np.arange(n_max))
            wr[:n_max] = wr[perm]
            wi[:n_max] = wi[perm]
            vr[:, :n_max] = vr[:, perm]
            vl[:, :n_max] = vl[:, perm]

    wr_out = np.zeros(L)
    vr_out = np.zeros((L, L))
    vl_out = np.zeros((L, L))
    wr_out[:ldu] = wr
    vr_out[:ldu, :ldu] = vr
    vl_out[:ldu, :ldu] = vl
    return (
        wr_out.astype(out_dtype),
        vr_out.astype(out_dtype),
        vl_out.astype(out_dtype),
        np.bool_(found_im),
    )


def _swap1(x: torch.Tensor, i, j) -> torch.Tensor:
    """x with its entries i and j (ints or one-element index tensors)
    exchanged, as a gather, so that no index is read on the host."""
    idx = torch.arange(x.shape[0], device=x.device)
    return x[torch.where(idx == i, j, torch.where(idx == j, i, idx))]


def _device_sort_park(wr, wi, ldu: int, n_sort: int) -> torch.Tensor:
    """The selection sort with complex parking of ``_host_reduced_eig`` as
    tensor ops: for each of the leading ``n_sort`` slots pick the smallest
    remaining real part; a complex candidate (|wi| > tol_im) is first
    swapped to the last unconsumed slot and the pick repeats once.
    Returns the permutation of the eigenpairs."""
    L = wr.shape[0]
    idx = torch.arange(L, device=wr.device)
    perm = idx.clone()
    mask = idx < ldu
    inf = torch.full((), math.inf, dtype=wr.dtype, device=wr.device)
    for i in range(n_sort):
        pick1 = torch.where(mask, wr[perm], inf).argmin().reshape(1)
        is_c = wi[perm].gather(0, pick1).abs() > _TOL_IM
        fin = (L - 1) - mask.flip(0).to(torch.uint8).argmax()
        mask_p = mask & (idx != fin)
        perm_p = _swap1(perm, fin, pick1)
        pick2 = torch.where(mask_p, wr[perm_p], inf).argmin().reshape(1)
        mask = torch.where(is_c, mask_p, mask) & (idx != i)
        perm = _swap1(torch.where(is_c, perm_p, perm), i,
                      torch.where(is_c, pick2, pick1))
    return perm


def _device_homing(vr, vl, copy_r, copy_l, ldu: int, n_max: int):
    """Max-overlap root homing as tensor ops (the twin of the homing in
    ``_host_reduced_eig``): first and second best overlaps a root,
    collisions resolved by the second-best values, the identity when they
    persist, and the two sides arbitrated by total overlap.  Returns the
    permutation of the eigenpairs."""
    L, dev = vr.shape[0], vr.device
    m2 = 2 * n_max
    ar = torch.arange(n_max, device=dev)
    ncols = min(m2, L)

    def overlaps(copy, v):
        vp = torch.zeros((L, m2), dtype=v.dtype, device=dev)
        vp[:, :ncols] = v[:, :ncols]
        return mTm(copy, vp)                               # (m2, m2)

    def pick(ov):
        colabs = ov[:, :n_max].abs()
        k1 = colabs.argmax(dim=0)
        colabs[k1, ar] = -math.inf
        k2 = colabs.argmax(dim=0)
        return k1, ov[k1, ar], k2, ov[k2, ar], (k1 != ar).any()

    idx_r, val_r, idx2_r, val2_r, mv_r = pick(overlaps(copy_r, vr))
    idx_l, val_l, _, _, mv_l = pick(overlaps(copy_l, vl))
    not_eye = ~torch.eye(n_max, dtype=torch.bool, device=dev)

    def has_double(idx):
        return ((idx[:, None] == idx[None, :]) & not_eye).any()

    double_r, double_l = has_double(idx_r), has_double(idx_l)
    both = idx_r
    if bool(double_r & double_l):
        # resolve the right side's collisions by the second-best overlaps,
        # pair by pair in order (only taken when both sides collide)
        idx = idx_r.clone()
        for j in range(n_max):
            for k in range(n_max):
                if k == j:
                    continue
                collide = idx[j] == idx[k]
                prefer_j = val2_r[j] > val2_r[k]
                new_j = torch.where(collide & prefer_j, idx2_r[j], idx[j])
                new_k = torch.where(collide & ~prefer_j, idx2_r[k], idx[k])
                idx[j], idx[k] = new_j, new_k
        both = torch.where(has_double(idx), ar, idx)
    only_r, only_l = double_r & ~double_l, double_l & ~double_r
    idx_r_f = torch.where(only_r, idx_l, torch.where(
        only_l, idx_r, torch.where(double_r & double_l, both, idx_r)))
    idx_l_f = torch.where(only_r, idx_l, torch.where(
        only_l, idx_r, torch.where(double_r & double_l, both, idx_l)))
    use_l = (idx_r_f != idx_l_f).any() & ~(val_r.sum() > val_l.sum())
    final = torch.where(use_l, idx_l_f, idx_r_f)
    ident = torch.arange(L, device=dev)
    perm = torch.cat([torch.where(final < ldu, final, ar), ident[n_max:]])
    return torch.where(mv_r | mv_l, perm, ident)


def _device_reduced_eig(g, ldu: int, n_sort: int, do_homing: bool, copy_r,
                        copy_l, n_max: int, off_tol):
    """The device twin of ``_host_reduced_eig`` on the leading ``ldu x
    ldu`` block of ``g``: the Eberlein eigensolve, the parking sort and
    the root homing, all on g's device.  Returns (wr, vr, vl) padded with
    zeros to g's size."""
    wr, wi, vr, vl = eberlein_eig(g[:ldu, :ldu], off_tol=off_tol)
    perm = _device_sort_park(wr, wi, ldu, min(n_sort, ldu))
    wr, vr, vl = wr[perm], vr[:, perm], vl[:, perm]
    if do_homing:
        perm = _device_homing(vr, vl, copy_r[:ldu], copy_l[:ldu], ldu, n_max)
        wr, vr, vl = wr[perm], vr[:, perm], vl[:, perm]
    full = g.shape[0]
    wr_out = torch.zeros((full,), dtype=g.dtype, device=g.device)
    vr_out = torch.zeros((full, full), dtype=g.dtype, device=g.device)
    vl_out = torch.zeros_like(vr_out)
    wr_out[:ldu] = wr
    vr_out[:ldu, :ldu] = vr
    vl_out[:ldu, :ldu] = vl
    return wr_out, vr_out, vl_out


@dataclasses.dataclass(frozen=True)
class NonsymPassResult:
    """Result of ONE one-sided pass (:func:`nonsym_pass`); ``eig`` and
    ``eig_h`` have ``options.shift`` removed."""

    eig: torch.Tensor
    evec: torch.Tensor
    ok: bool
    n_iter: int
    n_matvec: int
    done: torch.Tensor
    rms_h: torch.Tensor
    max_h: torch.Tensor
    eig_h: torch.Tensor
    ortho_ok: bool


def _check_driver(driver: str):
    if driver not in _DRIVERS:
        raise ValueError("driver must be 'auto', 'jit', 'device' or 'host'")


class _NonsymIteration(StepState):
    """One pass's fixed-shape state and the steps of an iteration over it,
    the reference's ``_NonsymState`` and its ``step_pre`` / ``step_post``.

    Every buffer is allocated once and written in place, and every count
    the steps use (``ldu``, ``n_act``, ``ldu_new``, ``n_frozen``, the
    preconditioner's shift) is a 0-d tensor on the device, so no step
    reads the device and each can be captured as a CUDA graph:

    1. :meth:`matvec`: the matvec block, its products scattered into
       ``aspace``, and the masked Gram matrix of the whole space in ``g``
       (``aspace . space^T`` on the left pass, ``space . aspace^T`` on the
       right); (between the steps, uncaptured) :meth:`reduced`, the
       nonsymmetric reduced solve of ``g``'s leading ``ldu_new`` block (the
       host dgeev, which reads ``g`` back, or the Eberlein solve on the
       device), its sort and root homing, written into ``wr`` and
       ``c_use``;
    2. :meth:`ritz`: the Ritz vectors, residuals, norms, locking and
       histories, and :attr:`flags`;
    3. :meth:`expand` or :meth:`restart`, as the host's count of
       expansions picks.

    A step 3 whose unrolled ortho loops fell short is found with the next
    iteration's flags: the iteration is undone, the step is run again with
    the eager loops from the inputs it kept (the preconditioned block, or
    for the restart a copy of the Ritz vectors, which the next ritz step
    overwrote), and the iteration is run again (``utils.graphs``).
    """

    BODIES = {"expand": "_expand_ortho", "restart": "_restart_body"}

    def __init__(self, op, precnd, guess, use_left, options, sqrtn,
                 budgets):
        self.op, self.precnd, self.use_left = op, precnd, use_left
        self.options, self.sqrtn = options, sqrtn
        n_max = self.n_max = options.n_max
        self.n_targ = options.n_targ
        lda_pad = self.lda_pad = options.dim_dav * n_max + n_max
        max_iter = options.max_iter
        n = guess.shape[1]
        dtype, dev = guess.dtype, guess.device

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        def full(value, *shape, dt=dtype):
            return torch.full(shape, value, dtype=dt, device=dev)

        self.rows = torch.arange(n_max, device=dev)
        self.rows_pad = torch.arange(lda_pad, device=dev)
        self.targ = self.rows < self.n_targ
        self.space = scatter_rows(zeros(lda_pad, n), guess, 0)
        self.aspace = zeros(lda_pad, n)
        self.g = zeros(lda_pad, lda_pad)
        # the reduced solve's results: the leading eigenvalues and the
        # pass's side of reduced eigenvectors
        self.wr = zeros(n_max)
        self.c_use = zeros(lda_pad, n_max)
        self.eig = zeros(n_max)
        self.evec = zeros(n_max, n)
        self.r = zeros(n_max, n)
        self.done = zeros(n_max, dt=torch.bool)
        self.rms = full(math.inf, n_max)
        self.rmx = full(math.inf, n_max)
        self.eig_h = zeros(max_iter, n_max)
        self.rms_h = full(math.inf, max_iter, n_max)
        self.max_h = full(math.inf, max_iter, n_max)
        i64 = torch.int64
        self.it = zeros(dt=i64)
        self.ldu = zeros(dt=i64)
        self.n_act = full(n_max, dt=i64)
        self.ldu_new = zeros(dt=i64)
        self.n_frozen = zeros(dt=i64)
        # step 3's inputs, kept for rerun
        self.pre = zeros(n_max, n)
        self.ldu_new3 = zeros(dt=i64)
        self.n_frozen3 = zeros(dt=i64)
        self.evec3 = zeros(n_max, n)
        self._init_steps(True, budgets, dev)

    # ---- step 1 ----
    def matvec(self):
        ldu_new = self.ldu + self.n_act
        block = gather_rows(self.space, self.ldu, self.n_max,
                            count=self.n_act)
        ablock = self.op(block)
        ablock = torch.where((self.rows < self.n_act)[:, None], ablock, 0.0)
        scatter_rows(self.aspace, ablock, self.ldu)
        # right pass: G[i,j] = s_i . (A s_j); left pass G[i,j] = (A^T l_i)
        # . l_j — both reduce A in the current basis
        col_ok = prefix_mask(self.lda_pad, ldu_new, device=ldu_new.device)
        g = (mmT(self.aspace, self.space) if self.use_left
             else mmT(self.space, self.aspace))
        self.g.copy_(torch.where(col_ok[:, None] & col_ok[None, :], g, 0.0))
        self.ldu_new.copy_(ldu_new)

    # ---- between the steps ----
    def reduced(self, ldu_new: int, n_sort: int, homing: bool, copies,
                on_device: bool):
        """The reduced solve of ``g``'s leading ``ldu_new`` block, sorted
        over ``n_sort`` slots and homed onto ``copies`` (the previous
        reduced eigenvectors of both sides) when ``homing``; writes ``wr``
        and ``c_use`` and returns this solve's copies."""
        n_max = self.n_max
        if on_device:
            # the reference's adaptive Eberlein target: the homing rests
            # on eigenvector overlaps, so an order of margin more than the
            # symmetric drivers and a tighter cap
            prev_rms = torch.where(~self.done, self.rms, math.inf).min()
            off_tol = torch.clamp(1e-3 * prev_rms, 0.0, 1e-6)
            wr, vr, vl = _device_reduced_eig(self.g, ldu_new, n_sort, homing,
                                             *copies, n_max, off_tol)
            self.wr.copy_(wr[:n_max])
            self.c_use.copy_((vl if self.use_left else vr)[:, :n_max])
            return vr[:, :2 * n_max], vl[:, :2 * n_max]
        np_dtype = (np.float64 if self.g.dtype == torch.float64
                    else np.float32)
        # the one read of the device besides the flags
        wr, vr, vl, _ = _host_reduced_eig(
            self.g.cpu().numpy(), ldu_new, n_sort, homing, *copies, n_max,
            out_dtype=np_dtype)
        # fresh pageable tensors each iteration: a copy from them returns
        # once the data is staged, so nothing here waits for the card
        self.wr.copy_(torch.from_numpy(wr[:n_max].copy()),
                      non_blocking=True)
        self.c_use.copy_(torch.from_numpy(
            (vl if self.use_left else vr)[:, :n_max].copy()),
            non_blocking=True)
        return vr[:, :2 * n_max].copy(), vl[:, :2 * n_max].copy()

    # ---- step 2 ----
    def ritz(self):
        self.keep_ritz()
        opts = self.options
        eig, c = self.wr, self.c_use
        evec = mTm(c, self.space)
        r = mTm(c, self.aspace) - eig[:, None] * evec
        active = ~self.done & self.targ
        rms = torch.where(active, norm_n(r) / self.sqrtn, self.rms)
        rmx = torch.where(active, amax_n(r.abs()), self.rmx)
        conv = (rms < opts.tol) & (rmx < opts.tol_max) & (self.it > 0)
        done = prefix_lock(self.done, conv, self.n_targ)
        at = self.it.view(1)
        self.eig_h.index_copy_(0, at, (eig - opts.shift)[None])
        self.rms_h.index_copy_(0, at, rms[None])
        self.max_h.index_copy_(0, at, rmx[None])
        self.eig.copy_(eig)
        self.evec.copy_(evec)
        self.r.copy_(r)
        self.rms.copy_(rms)
        self.rmx.copy_(rmx)
        self.done.copy_(done)
        self.ok.copy_(done[:self.n_targ].all())
        self.n_frozen.copy_(done.sum())
        self.it.add_(1)
        self.pack_flags()

    # ---- step 3 ----
    def expand(self):
        """Precondition the active residuals at the shift of the first
        active root, orthogonalize them against the space and append
        them."""
        n_max, n_frozen = self.n_max, self.n_frozen
        first = n_frozen.clamp(max=n_max - 1).view(1)
        shift = -self.eig.index_select(0, first).reshape(())
        rblk = gather_rows(self.r, n_frozen, n_max, count=n_max - n_frozen)
        umask = self.rows < n_max - n_frozen
        self.pre.copy_(torch.where(umask[:, None],
                                   self.precnd(shift, rblk), 0.0))
        self.ldu_new3.copy_(self.ldu_new)
        self.n_frozen3.copy_(n_frozen)
        self._expand_ortho()

    def _expand_ortho(self):
        n_act_new = self.n_max - self.n_frozen3
        umask = self.rows < n_act_new
        col_ok = self.rows_pad < self.ldu_new3
        with self._ortho() as rec:
            unew, o_done = _ortho_vs_x(self.space, self.pre, xmask=col_ok,
                                       umask=umask)
            scatter_rows(self.space, unew, self.ldu_new3)
        self._close(o_done, rec)
        self.ldu.copy_(self.ldu_new3)
        self.n_act.copy_(n_act_new)

    def restart(self):
        """Collapse the space onto the orthonormalized Ritz vectors."""
        self.evec3.copy_(self.evec)
        self._restart_body()

    def _restart_body(self):
        with self._ortho() as rec:
            ev, _, cd_ok = _ortho_cd(self.evec3)
            scatter_rows(self.space.zero_(), ev, 0)
        self.aspace.zero_()
        self._close(cd_ok, rec)
        self.ldu.zero_()
        self.n_act.fill_(self.n_max)


def _nonsym_pass(op, precnd, guess, options: SolverOptions, use_left: bool,
                 generator, sharding=None,
                 driver: str = "auto") -> NonsymPassResult:
    """One one-sided Davidson pass.

    ``op`` is A for the right pass and A^T for the left pass; ``use_left``
    selects which set of reduced eigenvectors drives the Ritz vectors and
    residuals (VL for the left pass) and the Gram layout.  ``driver``
    "device" solves the reduced problem on the operands' device, any
    other on the host.  Runs inside the caller's ``mm_sharding``.
    """
    on_device = driver == "device"
    n_max, max_iter = options.n_max, options.max_iter
    k_rows, n = guess.shape
    if k_rows != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows, got {k_rows}")
    dev = guess.device
    route = _route(dev, sharding)
    guess = check_guess(guess, generator)
    st = _NonsymIteration(op, precnd, guess, bool(use_left), options,
                          math.sqrt(global_n(n, sharding)), _budgets(route))
    loop = StepLoop("nonsym", st, dev, route, _SCOPES)
    # the previous reduced eigenvectors of both sides, for the homing: on
    # the host for the host dgeev, on the device for the device solve
    lda_pad = st.lda_pad
    if on_device:
        copies = (torch.zeros((lda_pad, 2 * n_max), dtype=guess.dtype,
                              device=dev),) * 2
    else:
        np_dtype = np.float64 if guess.dtype == torch.float64 else np.float32
        copies = (np.zeros((lda_pad, 2 * n_max), np_dtype),) * 2
    solved = [copies]

    def reduce(ldu_new, n_sort, homing, copies):
        solved[0] = st.reduced(ldu_new, n_sort, homing, copies, on_device)

    # the host's copies of the counts it needs: the reduced block's size
    # and the matvec count (ldu, n_act), the branch (m_dim) and whether the
    # space was just (re)started (fresh: no homing, a sort over n_max)
    ldu, n_act, m_dim, fresh = 0, n_max, 1, True
    ok, n_matvec, it = False, 0, 0
    with loop:
        while not ok and it < max_iter:
            ldu_new = ldu + n_act
            n_sort = n_max if fresh else n_max + n_act
            # an iteration run again (after a rerun) homes onto the copies
            # it had the first time
            ok, n_frozen = loop.iterate(functools.partial(
                reduce, ldu_new, n_sort, not fresh, copies))
            copies = solved[0]
            n_matvec += n_act
            if options.verbose:
                inflight_progress("nonsym", it, n_act, st.eig_h[it], st.rms,
                                  st.rmx)
            if not ok:
                if m_dim < options.dim_dav:
                    loop.branch("expand")
                    ldu, n_act, m_dim = ldu_new, n_max - n_frozen, m_dim + 1
                    fresh = False
                else:
                    loop.branch("restart")
                    ldu, n_act, m_dim, fresh = 0, n_max, 1, True
            it += 1
        ortho_ok = loop.close()
    loop.record(it, st.eig.dtype, options.verbose)
    return NonsymPassResult(
        eig=st.eig - options.shift, evec=st.evec, ok=ok, n_iter=it,
        n_matvec=n_matvec, done=st.done, rms_h=st.rms_h, max_h=st.max_h,
        eig_h=st.eig_h, ortho_ok=ortho_ok)


def nonsym(matvec, matvec_l, precnd, evec_guess: torch.Tensor,
           options: SolverOptions, side: str = "c", *,
           generator: torch.Generator | None = None, sharding=None,
           driver: str = "auto") -> NonsymResult:
    """Two-sided Davidson for a real nonsymmetric matrix.

    Args:
      matvec: A applied to row vectors; matvec_l: A^T applied to row
        vectors (only needed for sides 'l', 's', 'c').
      precnd: ``(shift, block) -> block`` like the symmetric drivers.
      evec_guess: (n_max, n) guess rows (the right guess; the left pass of
        a consecutive run is seeded from the right eigenvectors).  Its
        dtype and device are the solve's.  Zeros mean a random start from
        ``generator``.
      side: 'r' right only, 'l' left only, 's'/'c' both consecutively.
      sharding: optional VectorSharding; ``evec_guess``, the callbacks'
        blocks and the returned vectors are then this rank's column
        shards.
      driver: "auto", "jit" and "host" solve the reduced problem with the
        host dgeev; "device" with the Eberlein Jacobi on the operands'
        device.

    Returns a :class:`NonsymResult`.  For 'c'/'s', ``ok`` also requires the
    left-pass eigenvalues to match the right-pass ones within tol, and
    evec_l is rebiorthonormalized so that evec_l @ evec_r^T = I.
    """
    if side not in ("r", "l", "s", "c"):
        raise ValueError("side must be one of 'r', 'l', 's', 'c'")
    _check_driver(driver)
    kw = dict(generator=generator, sharding=sharding, driver=driver)
    with routing_for(options, "nonsym"), mm_sharding(sharding):
        if side in ("r", "l"):
            op = matvec if side == "r" else matvec_l
            out = _nonsym_pass(op, precnd, evec_guess, options,
                               use_left=side == "l", **kw)
            zero_v = torch.zeros_like(out.evec)
            zero_h = torch.zeros_like(out.rms_h)
            is_r = side == "r"
            return NonsymResult(
                eig=out.eig,
                evec_r=out.evec if is_r else zero_v,
                evec_l=zero_v if is_r else out.evec,
                ok=out.ok, n_iter=out.n_iter, n_matvec=out.n_matvec,
                done=out.done,
                rms_history_r=out.rms_h if is_r else zero_h,
                max_history_r=out.max_h if is_r else zero_h,
                rms_history_l=zero_h if is_r else out.rms_h,
                max_history_l=zero_h if is_r else out.max_h,
                eig_history=out.eig_h, ortho_ok=out.ortho_ok)
        # consecutive: right pass, then the left pass seeded from evec_r
        out_r = _nonsym_pass(matvec, precnd, evec_guess, options,
                             use_left=False, **kw)
        guess_l, seed_ok = nonsym_seed_left(out_r.evec)
        out_l = _nonsym_pass(matvec_l, precnd, guess_l, options,
                             use_left=True, **kw)
        return _consecutive_result(out_r, out_l, seed_ok, options)


def nonsym_seed_left(evec_r: torch.Tensor, *, sharding=None):
    """Left-pass seed from the right eigenvectors: their orthonormalized
    copy.  Returns ``(guess_l, ok)``.  Under ``sharding`` (or inside a
    sharded solve) ``evec_r`` is the rank's column shard and the overlaps
    are all-reduced."""
    with (mm_sharding(sharding) if sharding is not None
          else contextlib.nullcontext()):
        guess_l, _, seed_ok = ortho_cd(evec_r)
    return guess_l, seed_ok


def _consecutive_result(out_r: NonsymPassResult, out_l: NonsymPassResult,
                        seed_ok: bool, options: SolverOptions
                        ) -> NonsymResult:
    n_max = options.n_max
    targ = torch.arange(n_max, device=out_r.eig.device) < options.n_targ
    eig_match = float(torch.where(targ, (out_r.eig - out_l.eig).abs(),
                                  0.0).max()) <= options.tol
    ok = out_r.ok and out_l.ok and eig_match
    # The reference calls svd_biortho here, but the overlap of converged
    # eigenpairs is near +/-identity, so its singular values are degenerate
    # and the SVD rotates inside the cluster, scrambling the eigenvalue <->
    # vector pairing.  The pairing-preserving equivalent is a solve:
    # evec_l <- O^{-1} evec_l (QR of the overlap, then a triangular solve)
    # gives evec_l @ evec_r^T = I, perturbing each vector at the size of
    # its residual.  The overlap is all-reduced under a sharding; the
    # solve acts on the small axis and stays local.
    overlap = mmT(out_l.evec, out_r.evec)
    q, r_ = torch.linalg.qr(overlap)
    evec_l = torch.linalg.solve_triangular(r_, mTm(q, out_l.evec),
                                           upper=True)
    return NonsymResult(
        eig=out_l.eig, evec_r=out_r.evec, evec_l=evec_l, ok=ok,
        n_iter=out_r.n_iter + out_l.n_iter,
        n_matvec=out_r.n_matvec + out_l.n_matvec,
        done=out_l.done,
        rms_history_r=out_r.rms_h, max_history_r=out_r.max_h,
        rms_history_l=out_l.rms_h, max_history_l=out_l.max_h,
        eig_history=out_l.eig_h,
        ortho_ok=out_r.ortho_ok and seed_ok and out_l.ortho_ok)


def nonsym_pass(matvec, precnd, evec_guess: torch.Tensor,
                options: SolverOptions, *, use_left: bool = False,
                generator: torch.Generator | None = None, sharding=None,
                driver: str = "auto") -> NonsymPassResult:
    """One one-sided Davidson pass as a public building block.

    ``matvec`` is the operator of this side (A for right, A^T for left),
    ``use_left`` a plain bool.  With :func:`nonsym_seed_left` and
    :func:`nonsym_finalize` as the glue (given the same ``sharding``) it
    reproduces ``nonsym(side='c')``.  Returns a :class:`NonsymPassResult`
    (``eig`` has ``options.shift`` removed).
    """
    if not isinstance(use_left, (bool, np.bool_)):
        raise TypeError("use_left must be a bool")
    _check_driver(driver)
    with routing_for(options, "nonsym"), mm_sharding(sharding):
        return _nonsym_pass(matvec, precnd, evec_guess, options,
                            use_left=bool(use_left), generator=generator,
                            sharding=sharding, driver=driver)


def nonsym_finalize(res_r: NonsymPassResult, res_l: NonsymPassResult,
                    options: SolverOptions, seed_ok=None, *,
                    sharding=None) -> NonsymResult:
    """Consecutive-mode finalize over two one-sided pass results (right,
    then left seeded by :func:`nonsym_seed_left`): the eigenvalue
    cross-check and the pairing-preserving biorthonormalization that
    ``nonsym(side='c')`` applies (its overlap all-reduced under
    ``sharding``).  ``seed_ok`` is ANDed into ``ortho_ok`` when given."""
    with routing_for(options, "nonsym"), mm_sharding(sharding):
        return _consecutive_result(res_r, res_l,
                                   True if seed_ok is None else bool(seed_ok),
                                   options)


# the profiler scope of each step (the restart has none)
_SCOPES = {"matvec": "matvec", "ritz": "rayleigh-ritz",
           "expand": "expand-ortho"}

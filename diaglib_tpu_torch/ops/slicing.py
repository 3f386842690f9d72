"""Ozaki-style integer slices of floating-point operands (port of
``diaglib_tpu/ops/slicing.py``).

A row of x is put on a power-of-two grid and peeled into int8 planes,

    x[m, :] = scale_m * sum_i q_i[m, :] * 2^{-bits*(i+1)},   q_i integer,

so that products of planes are exact int8 x int8 -> int32 sums and the
float result is an exactly weighted sum of them.  Every step of the peel
is exact float32 arithmetic on the (hi, mid, lo) float32 triple of a
float64 value, so the planes are integers that any correct implementation
reproduces bit for bit.

Kernel K2 (``csrc/peel.cu``) has two wrappers: :func:`slice_rows`, the x
side of the sliced matvec in one launch (x to planes and row scales), and
:func:`peel_rows`, the planes of pre-scaled values.  On CPU tensors they
run :func:`slice_rows_plain` and :func:`peel_rows_plain`, the same chains
in torch.  Kernel K3 (``csrc/wide_mm.cu``, :func:`sliced_wide_mm`) is the
exact small-K, wide-output product of the solvers' rotations.

:func:`sliced_mm`, :func:`sliced_mmT` and :func:`sliced_mTm`, the exact
long contractions of ``SolverOptions(sliced_mm="always")``, are plain
torch around K2's peel, as the reference's are plain XLA: one int8 matmul
of all plane pairs (``torch._int_mm`` on the card) and the reference's
level combine, bit-equal to it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["pow2_grid", "slice_operand", "slice_scaled",
           "slice_scaled_components", "combine_weights", "peel_rows",
           "peel_rows_plain", "fits_exact", "sliced_mm", "sliced_mmT",
           "sliced_mTm", "wide_feasible", "sliced_wide_mm",
           "sliced_wide_mm_plain"]

_BITS = 6
_SLICES = 9  # 54 bits >= f64's 53-bit mantissa
_X_BITS = 7  # the sliced matvec's x planes: a doubled grid, |q| <= 64


def pow2_grid(m: torch.Tensor) -> torch.Tensor:
    """Least power of two s >= m elementwise, as float64 (0 -> 1).

    The exponent is clamped to [-1022, 1023], so the grid stays a normal
    float64 (inf -> 2^1023).  Values below the smallest normal number of
    ``m``'s dtype count as zero and get 1, as on a device that flushes
    denormals.
    """
    m = torch.as_tensor(m)
    live = m >= torch.finfo(m.dtype).tiny
    m = m.to(torch.float64)
    mant, e = torch.frexp(m)            # m = mant * 2^e, 0.5 <= mant < 1
    e = torch.where(mant == 0.5, e - 1, e).clamp(-1022, 1023)
    s = torch.ldexp(torch.ones_like(m), e)
    s = torch.where(torch.isinf(m), 2.0 ** 1023, s)
    return torch.where(live, s, 1.0)


def slice_scaled_components(hi, mid, lo, n_slices: int = _SLICES,
                            bits: int = _BITS) -> torch.Tensor:
    """``(n_slices,) + hi.shape`` int8 planes of the pre-scaled float32
    triple (hi, mid, lo): |hi + mid + lo| <= 1, |mid| <= |t| 2^-24 and
    |lo| <= |t| 2^-48.  mid joins the peel once bits*(i+1) >= 24 (it
    rounds to zero before), lo once bits*(i+1) >= 48."""
    planes = []
    rem_hi, rem_mid, rem_lo = hi, mid, lo
    for i in range(n_slices):
        w = 2.0 ** (-bits * (i + 1))
        inv = 2.0 ** (bits * (i + 1))
        q = torch.round(rem_hi * inv)
        rem_hi = rem_hi - q * w
        if bits * (i + 1) >= 24:
            q2 = torch.round(rem_mid * inv)
            rem_mid = rem_mid - q2 * w
            q = q + q2
        if bits * (i + 1) >= 48:
            q3 = torch.round(rem_lo * inv)
            rem_lo = rem_lo - q3 * w
            q = q + q3
        planes.append(q.to(torch.int8))
    return torch.stack(planes)


def _split(t: torch.Tensor):
    """Exact float32 triple of pre-scaled ``t`` (mid = lo = 0 for float32)."""
    hi = t.to(torch.float32)
    if t.dtype == torch.float64:
        d = t - hi.to(torch.float64)
        mid = d.to(torch.float32)
        lo = (d - mid.to(torch.float64)).to(torch.float32)
    else:
        mid = torch.zeros_like(hi)
        lo = torch.zeros_like(hi)
    return hi, mid, lo


def slice_scaled(t: torch.Tensor, n_slices: int = _SLICES,
                 bits: int = _BITS) -> torch.Tensor:
    """int8 planes of pre-scaled ``t`` with |t| <= 1 (see slice_operand)."""
    return slice_scaled_components(*_split(t), n_slices=n_slices, bits=bits)


def peel_rows_plain(t_or_components, nx: int, bits: int) -> torch.Tensor:
    """The plain torch version of kernel K2: ``(nx,) + shape`` int8 planes
    of a pre-scaled tensor or of its (hi, mid, lo) float32 triple."""
    if isinstance(t_or_components, tuple):
        return slice_scaled_components(*t_or_components, n_slices=nx,
                                       bits=bits)
    return slice_scaled(t_or_components, n_slices=nx, bits=bits)


def _peel_lib():
    lib = _build.library("peel")
    if not getattr(lib, "_typed", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.slice_rows.argtypes = [p, i32, i64, i64, p] + [i32] * 6 + [p] * 3
        lib.slice_rows.restype = i32
        lib.peel_prescaled.argtypes = [p, p, p, i32, i64, i32, i32, i32, p,
                                       p]
        lib.peel_prescaled.restype = i32
        lib.peel_error_string.argtypes = [i32]
        lib.peel_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def peel_rows(t_or_components, nx: int, bits: int) -> torch.Tensor:
    """``(nx,) + shape`` int8 planes of pre-scaled values (kernel K2's
    pre-scaled entry, the grid pinned to 1).

    ``t_or_components`` is a float64 or float32 tensor ``t`` whose top
    plane fits int8 (|t| <= 1/2 at 7 bits, <= 1 at 6), or a (hi, mid, lo)
    tuple of float32 tensors.  On the CPU
    this is :func:`peel_rows_plain`; on a CUDA tensor it launches
    ``csrc/peel.cu`` (bit-identical) or raises.
    """
    comps = t_or_components if isinstance(t_or_components, tuple) else None
    first = comps[0] if comps is not None else t_or_components
    if first.device.type == "cpu":
        return peel_rows_plain(t_or_components, nx, bits)
    if first.device.type != "cuda":
        raise ValueError(f"peel_rows: unsupported device {first.device}")
    if nx <= 0 or bits <= 0 or bits * nx >= 127:
        raise ValueError(f"peel_rows: nx={nx} planes of {bits} bits")
    if comps is not None:
        if (len(comps) != 3 or any(c.dtype != torch.float32 for c in comps)
                or any(c.shape != first.shape or c.device != first.device
                       for c in comps)):
            raise ValueError("peel_rows: components must be three float32 "
                             "tensors of one shape on one device")
        comps = tuple(c.contiguous() for c in comps)
        first, mode = comps[0], 2
    elif first.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"peel_rows: unsupported dtype {first.dtype}")
    else:
        first = first.contiguous()
        mode = 0 if first.dtype == torch.float64 else 1
    n = first.shape[-1] if first.ndim else 1
    rows = first.numel() // n if n else 0
    if n >= 2 ** 31 or rows >= 2 ** 31:
        raise ValueError(f"peel_rows: shape {tuple(first.shape)} too large")
    out = torch.empty((nx,) + tuple(first.shape), dtype=torch.int8,
                      device=first.device)
    lib = _peel_lib()
    # the raw handle: torch.cuda.current_stream() costs microseconds of a
    # call this short
    stream = torch._C._cuda_getCurrentRawStream(first.device.index)
    mid, lo = ((comps[1].data_ptr(), comps[2].data_ptr()) if comps
               else (None, None))
    err = lib.peel_prescaled(first.data_ptr(), mid, lo, mode, rows, n, nx,
                             bits, out.data_ptr(), stream)
    if err:
        raise RuntimeError(
            f"peel kernel: {lib.peel_error_string(err).decode()}")
    peel_rows.launches += 1
    return out


peel_rows.launches = 0     # every launch of K2, through either entry


def slice_rows_plain(x: torch.Tensor, nx: int, *, col_scale=None,
                     acc_dtype=None, work_dtype=None, sx_dtype=None):
    """The plain torch version of kernel K2's fused entry: ``(nx, k, n)``
    int8 planes of 2-D ``x`` on its per-row grid at 7 bits, and the row
    scales ``sx`` ``(k, 1)``.

    The chain the sliced matvecs run, step by step: ``work = x`` cast to
    ``acc_dtype`` (x's own by default), times ``col_scale.to(acc_dtype)``
    where a column grid ``col_scale`` ``(n,)`` is given (powers of two,
    exact unless float32 leaves its range), cast to ``work_dtype`` (the
    accumulation type by default); ``sx = 2 * pow2_grid(max|work|)`` per
    row (pow2_grid's rule for the work type: a NaN propagates through the
    max and gives sx = 2, inf gives sx = inf); ``t = work / sx`` in float64,
    rounded back to the work type; :func:`peel_rows_plain` of t at 7 bits.
    ``sx`` comes back in ``sx_dtype`` (the accumulation type by default).
    """
    acc = x.dtype if acc_dtype is None else acc_dtype
    work = x.to(acc)
    if col_scale is not None:
        work = work * col_scale.to(acc)
    work = work.to(acc if work_dtype is None else work_dtype)
    t, sx = _row_grid(work, _X_BITS)
    return (peel_rows_plain(t, nx, _X_BITS),
            sx.to(acc if sx_dtype is None else sx_dtype))


_FLOATS = (torch.float32, torch.float64)


def slice_rows(x: torch.Tensor, nx: int, *, col_scale=None, acc_dtype=None,
               work_dtype=None, sx_dtype=None):
    """The x side of a sliced matvec (kernel K2's fused entry): the planes
    and row scales of :func:`slice_rows_plain`, bit for bit.

    On CPU tensors this is the plain version.  On a CUDA tensor it is one
    launch of ``csrc/peel.cu``, which reads x (any strides) and
    ``col_scale`` once, takes each row's grid on the card and writes the
    planes and ``sx``; it raises ``ValueError`` on arguments the kernel
    does not take (x not 2-D float32 / float64, ``col_scale`` not a
    contiguous ``(n,)`` tensor of the accumulation type on x's device, a
    float32 work type over a float64 accumulation type, nx outside 1..8)
    and ``RuntimeError`` when the launch fails.
    """
    if x.device.type == "cpu":
        return slice_rows_plain(x, nx, col_scale=col_scale,
                                acc_dtype=acc_dtype, work_dtype=work_dtype,
                                sx_dtype=sx_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"slice_rows: unsupported device {x.device}")
    acc = x.dtype if acc_dtype is None else acc_dtype
    work = acc if work_dtype is None else work_dtype
    sxd = acc if sx_dtype is None else sx_dtype
    if (x.ndim != 2 or x.dtype not in _FLOATS or acc not in _FLOATS
            or work not in _FLOATS or sxd not in _FLOATS
            or (work == torch.float32 and acc == torch.float64)):
        raise ValueError(f"slice_rows: unsupported x {x.dtype} "
                         f"{tuple(x.shape)} or types {acc}, {work}, {sxd}")
    k, n = x.shape
    if not 0 < nx <= 8 or n == 0 or n >= 2 ** 31 or k >= 2 ** 26:
        raise ValueError(f"slice_rows: nx={nx} planes of x {(k, n)}")
    if col_scale is not None and (
            col_scale.dtype != acc or col_scale.shape != (n,)
            or col_scale.device != x.device
            or not col_scale.is_contiguous()):
        raise ValueError(f"slice_rows: col_scale must be a contiguous {acc} "
                         f"({n},) tensor on {x.device}")
    planes = torch.empty((nx, k, n), dtype=torch.int8, device=x.device)
    sx = torch.empty((k, 1), dtype=sxd, device=x.device)
    if k == 0:
        return planes, sx
    lib = _peel_lib()
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    f32 = torch.float32
    err = lib.slice_rows(
        x.data_ptr(), x.dtype == f32, x.stride(0), x.stride(1),
        None if col_scale is None else col_scale.data_ptr(), k, n, nx,
        acc == f32, work == f32, sxd == f32, planes.data_ptr(),
        sx.data_ptr(), stream)
    if err:
        raise RuntimeError(
            f"peel kernel: {lib.peel_error_string(err).decode()}")
    peel_rows.launches += 1
    return planes, sx


def slice_operand(x: torch.Tensor, axis: int, n_slices: int = _SLICES,
                  bits: int = _BITS):
    """int8 planes of 2-D ``x`` on a power-of-two grid per line along the
    contraction axis ``axis`` (-1: a grid per row; 0: a grid per column).

    Returns ``(planes, scale)``: ``planes`` is ``(n_slices,) + x.shape``
    int8, ``scale`` is x's shape with ``axis`` reduced to 1 (float64), and
    ``x ~= scale * sum_i planes[i] * 2^{-bits*(i+1)}`` to
    ``2^{-bits*n_slices}`` of each line's max.  At ``bits >= 7`` the grid
    is doubled (|t| <= 1/2) so the top plane stays inside int8.  Float32
    ``x`` is peeled from float32 (mid = lo = 0), float64 from its triple.
    Rows at 7 bits and up to 8 planes go through :func:`slice_rows` (one
    launch of K2 on the card); otherwise the grid is taken in torch and
    K2's pre-scaled entry peels.
    """
    ax = axis % x.ndim
    if bits == _X_BITS and 0 < n_slices <= 8 and x.ndim == 2 and ax == 1:
        return slice_rows(x, n_slices, sx_dtype=torch.float64)
    t, scale = _row_grid(x, bits, ax)
    return peel_rows(t, n_slices, bits), scale


def _row_grid(x: torch.Tensor, bits: int, axis: int = -1):
    """(t, scale) of slice_operand: x's lines along ``axis`` divided by
    their grid."""
    scale = pow2_grid(x.abs().amax(dim=axis, keepdim=True))
    if bits >= 7:
        scale = 2.0 * scale
    # exact: a power-of-two division, done in float64 so that no float32
    # reciprocal of a tiny grid overflows
    t = (x.to(torch.float64) / scale).to(x.dtype)
    return t, scale


def combine_weights(n_levels: int, bits: int = _BITS,
                    dtype=torch.float64, device=None) -> torch.Tensor:
    """(n_levels,) weights 2^{-bits*(L+2)} for level-summed plane products."""
    return torch.tensor([2.0 ** (-bits * (lev + 2))
                         for lev in range(n_levels)], dtype=dtype,
                        device=device)


# ---------------------------------------------------------------------------
# long contractions (the Gram products of sliced_mm="always")
# ---------------------------------------------------------------------------

def fits_exact(k: int, bits: int = _BITS) -> bool:
    """True iff a length-k contraction of ``bits``-bit plane products
    accumulates exactly in int32 (products below 2^{2*bits+2}, k of them
    below 2^31)."""
    return (2 * bits + 2) + max(1, k).bit_length() <= 31


def _check_exact(k: int, bits: int):
    if not fits_exact(k, bits):
        raise ValueError(f"contraction length {k} overflows exact int32 "
                         f"accumulation at {bits}-bit slices")


def _slice_pair_products(xs: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """All plane-pair products at once: ``xs`` (ns1, M, K) and ``bs``
    (ns2, K, N) int8 give (ns1, M, ns2, N) int32, exactly.

    On CUDA tensors this is one ``torch._int_mm`` (int8 x int8 -> int32 on
    the tensor cores), its operands padded with zero rows and columns to
    the shapes it takes (more than 16 rows, K and the columns multiples of
    8), which changes no sum; elsewhere a float64 product of the
    integer-valued planes, exact because every sum stays below 2^53.
    """
    ns1, mdim, k = xs.shape
    ns2, k2, ndim = bs.shape
    if k != k2:
        raise ValueError(f"plane products: K {k} != {k2}")
    lhs = xs.reshape(ns1 * mdim, k)
    rhs_t = bs.permute(0, 2, 1).reshape(ns2 * ndim, k)   # (ns2*N, K)
    rows, cols = lhs.shape[0], rhs_t.shape[0]
    if lhs.device.type == "cuda":
        pad_k = -k % 8
        lhs = torch.nn.functional.pad(lhs, (0, pad_k, 0, max(17 - rows, 0)))
        rhs_t = torch.nn.functional.pad(rhs_t, (0, pad_k, 0, -cols % 8))
        out = torch._int_mm(lhs, rhs_t.T)[:rows, :cols]
    else:
        out = (lhs.to(torch.float64) @ rhs_t.to(torch.float64).T).to(
            torch.int32)
    return out.reshape(ns1, mdim, ns2, ndim)


def _combine(prods: torch.Tensor, sx: torch.Tensor, sa: torch.Tensor,
             bits: int, k: int) -> torch.Tensor:
    """The float64 result from the int32 plane products, in the
    reference's order, so the two agree bit for bit.

    ``prods`` (ns1, M, ns2, N), ``sx`` (M, 1) and ``sa`` (1, N) scales,
    ``k`` the contraction length (it bounds each product for the int32
    headroom test).  The pair products of one level are summed first, in
    int32 where the level sum provably fits (float64 otherwise, still
    exact), and the levels are added deepest diagonal first; the weights
    and scales are powers of two, so the only rounding is the float64
    summation of the levels.
    """
    ns1, ns2 = prods.shape[0], prods.shape[2]
    headroom = 31 - ((2 * bits + 2) + max(1, k).bit_length())
    total = torch.zeros((prods.shape[1], prods.shape[3]), dtype=torch.float64,
                        device=prods.device)
    for lev in range(ns1 + ns2 - 2, -1, -1):
        pairs = [prods[i, :, lev - i, :]
                 for i in range(ns1) if 0 <= lev - i < ns2]
        exact_i32 = headroom >= (len(pairs) - 1).bit_length()
        acc = None
        for p in pairs:
            p = p if exact_i32 else p.to(torch.float64)
            acc = p if acc is None else acc + p
        total = total + acc.to(torch.float64) * 2.0 ** (-bits * (lev + 2))
    return total * sx * sa


def _check_pair(name, a, b, k_a, k_b):
    if a.ndim != 2 or b.ndim != 2 or k_a != k_b:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on two devices")


def sliced_mm(a: torch.Tensor, b: torch.Tensor, n_slices: int = _SLICES,
              bits: int = _BITS) -> torch.Tensor:
    """Float64 ``a @ b`` through exact integer slices: a cut into planes
    on a grid per row, b on a grid per column, every plane-pair product an
    exact int32 sum, the levels combined as the reference does.  Both
    operands are truncated ``bits * n_slices`` bits below their line
    maxima (54 > 53 at the defaults); there is no rounding inside the
    contraction.  Raises ``ValueError`` when the contraction overflows the
    int32 budget (:func:`fits_exact`)."""
    _check_pair("sliced_mm", a, b, a.shape[-1], b.shape[0])
    _check_exact(a.shape[-1], bits)
    xs, sx = slice_operand(a, -1, n_slices, bits)
    bs, sb = slice_operand(b, 0, n_slices, bits)
    return _combine(_slice_pair_products(xs, bs), sx, sb, bits, a.shape[-1])


def sliced_mmT(a: torch.Tensor, b: torch.Tensor, n_slices: int = _SLICES,
               bits: int = _BITS) -> torch.Tensor:
    """Float64 ``a @ b.T`` (the Gram layout, contracting the last axes)
    as :func:`sliced_mm`."""
    _check_pair("sliced_mmT", a, b, a.shape[-1], b.shape[-1])
    _check_exact(a.shape[-1], bits)
    xs, sx = slice_operand(a, -1, n_slices, bits)
    bs, sb = slice_operand(b, -1, n_slices, bits)
    prods = _slice_pair_products(xs, bs.transpose(1, 2))
    return _combine(prods, sx, sb.T, bits, a.shape[-1])


def sliced_mTm(a: torch.Tensor, b: torch.Tensor, n_slices: int = _SLICES,
               bits: int = _BITS) -> torch.Tensor:
    """Float64 ``a.T @ b`` (contracting the first axes) as
    :func:`sliced_mm`."""
    _check_pair("sliced_mTm", a, b, a.shape[0], b.shape[0])
    _check_exact(a.shape[0], bits)
    xs, sx = slice_operand(a, 0, n_slices, bits)
    bs, sb = slice_operand(b, 0, n_slices, bits)
    prods = _slice_pair_products(xs.transpose(1, 2), bs)
    return _combine(prods, sx.T, sb, bits, a.shape[0])


# ---------------------------------------------------------------------------
# wide-output small-K contraction (the solvers' rotations and projections)
# ---------------------------------------------------------------------------

_WIDE_BITS = _X_BITS  # half grid, |q| <= 64
_WIDE_SLICES = 8      # 7 * 8 - 1 = 55 >= 53 mantissa bits
_WIDE_LEVELS = 9      # levels i + p < 9 are kept


def _fits_int32(kdim: int, bits: int = _WIDE_BITS) -> bool:
    """The reference's exact-int32 bound: 2*(bits-1)+1 bits a product."""
    return kdim * (1 << (2 * (bits - 1) + 1)) <= (1 << 31)


def wide_feasible(m: int, kdim: int, n: int, n_slices: int = _WIDE_SLICES,
                  bits: int = _WIDE_BITS) -> bool:
    """True iff :func:`sliced_wide_mm` can run ``(m, kdim) @ (kdim, n)``
    exactly: the int32 budget of the (4-padded) contraction holds.  The
    reference also asks for a TPU lane tile that fits VMEM; the CUDA kernel
    stages the contraction in chunks, so any K within the budget runs."""
    return _fits_int32(kdim + (-kdim) % 4, bits)


def _wide_levels(n_slices: int) -> int:
    """Levels i + p kept by the wide product: the reference's
    ``min(2 n_slices - 1, 9)``."""
    return min(2 * n_slices - 1, _WIDE_LEVELS)


def _wide_operands(a: torch.Tensor, b: torch.Tensor,
                   n_slices: int = _WIDE_SLICES, bits: int = _WIDE_BITS):
    """The plain version's operands, as the kernel makes them for itself:
    a's planes ``(n_slices, m, K)``, its row grid ``sa`` (m, 1) and b's
    column grid ``sb`` (1, n), ``sb = 2 * pow2_grid(max|b| per column)``."""
    t, sa = _row_grid(a, bits)
    a_sl = peel_rows_plain(t, n_slices, bits)
    sb = 2.0 * pow2_grid(b.abs().amax(dim=0, keepdim=True))
    return a_sl, sa, sb


def _wide_check(a, b, bits: int = _WIDE_BITS):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"sliced_wide_mm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise ValueError("sliced_wide_mm: float64 operands only")
    if a.device != b.device:
        raise ValueError("sliced_wide_mm: operands on two devices")
    if not _fits_int32(a.shape[1], bits):
        raise ValueError(f"K={a.shape[1]} overflows exact int32 "
                         "accumulation")


def _two_sum(s: torch.Tensor, t: torch.Tensor):
    """Knuth's 2Sum in float32: ``x + err == s + t`` exactly."""
    x = s + t
    bb = x - s
    return x, (s - (x - bb)) + (t - bb)


def _triple_combine(levels, bits: int) -> torch.Tensor:
    """The reference kernel's combine of the integer level sums
    ``levels[L]`` (int64 values of int32 range): deepest level first, each
    split exactly into ``(v >> 12) << 12`` and the low 12 bits, weighted
    by 2^{-bits(L+2)} in float32 (exact) and summed into a float32 triple
    by a 2Sum cascade; the triple's float64 sum is returned."""
    zero = torch.zeros(levels[0].shape, dtype=torch.float32,
                       device=levels[0].device)
    s_hi, s_mid, s_lo = zero, zero, zero
    for L in range(len(levels) - 1, -1, -1):
        w = 2.0 ** (-bits * (L + 2))
        v = levels[L]
        vh = (v >> 12) << 12
        for part in (vh, v - vh):
            t = part.to(torch.float32) * w
            s_hi, e = _two_sum(s_hi, t)
            s_mid, e2 = _two_sum(s_mid, e)
            s_lo = s_lo + e2
    return (s_hi.to(torch.float64) + s_mid.to(torch.float64)
            + s_lo.to(torch.float64))


def sliced_wide_mm_plain(a: torch.Tensor, b: torch.Tensor,
                         n_slices: int = _WIDE_SLICES,
                         bits: int = _WIDE_BITS) -> torch.Tensor:
    """The plain torch version of kernel K3: exact-slice float64 ``a @ b``.

    b / sb is cut into ``n_slices`` planes of ``bits`` bits per element
    as the kernel cuts it; each level sum ``v_L = sum_{i+p=L} a_i @ q_p``
    is a float64 matmul of integers below 2^53, so it is exact; the levels
    are combined as the JAX kernel combines them (an exact float32 triple,
    :func:`_triple_combine`) and scaled by sa * sb.  The kernel and the
    JAX package's ``sliced_wide_mm`` agree with it bit for bit.  Any pair
    (n_slices, bits) within the int32 bound runs here; the kernel takes
    (8, 7) only.
    """
    _wide_check(a, b, bits)
    m, n = a.shape[0], b.shape[1]
    nlev = _wide_levels(n_slices)
    a_sl, sa, sb = _wide_operands(a, b, n_slices, bits)
    a_sl = a_sl.to(torch.float64)                      # (ns, m, K)
    q = peel_rows_plain(b / sb, n_slices, bits)        # (ns, K, n)
    lev = [torch.zeros((m, n), dtype=torch.float64, device=a.device)
           for _ in range(nlev)]
    for p in range(n_slices):
        qp = q[p].to(torch.float64)
        for i in range(min(n_slices, nlev - p)):
            lev[i + p] += a_sl[i] @ qp
    y = _triple_combine([v.to(torch.int64) for v in lev], bits)
    return y * sa * sb


def _wide_lib():
    lib = _build.library("wide_mm")
    if not getattr(lib, "_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wide_mm.argtypes = [p, i64, i64, p, i64, i64, p, p, i32, i32,
                                i32, p]
        lib.wide_mm.restype = i32
        lib.wide_mm_error_string.argtypes = [i32]
        lib.wide_mm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


_WIDE_ROWS = 16       # rows of a a tile of the kernel (its grid's y)
_WIDE_CHUNK = 32      # the kernel's contraction chunk


def _wide_scratch_bytes(m: int, kdim: int) -> int:
    """Bytes of the kernel's scratch (the C entry wide_mm_scratch_bytes):
    a's int8 planes, 8 x 16 x 32 a (row tile, chunk of K), then its float64
    row grids, 16 a row tile, then an int32 tile counter a row tile."""
    tiles = -(-m // _WIDE_ROWS)
    return tiles * (-(-kdim // _WIDE_CHUNK) * 8 * _WIDE_ROWS * _WIDE_CHUNK
                    + 8 * _WIDE_ROWS + 4)


_wide_scratches: dict = {}
_wide_replaced: list = []


def _wide_scratch(device: torch.device, stream: int, nbytes: int):
    """The kernel's scratch for calls on ``stream``: one buffer a (device,
    stream), grown as needed.  Launches on one stream run in order, so each
    call's a-side launch writes it only after the last call's kernel has
    read it.  A replaced buffer is kept for the life of the process
    (``_wide_replaced``; each is smaller than the one after it): a CUDA
    graph captured over it writes it at every replay, which may come long
    after (``utils.graphs.StepCache``)."""
    key = (device.index, stream)
    buf = _wide_scratches.get(key)
    if buf is None or buf.numel() < nbytes:
        if buf is not None:
            _wide_replaced.append(buf)
        buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                          device=device)
        _wide_scratches[key] = buf
    return buf


def sliced_wide_mm(a: torch.Tensor, b: torch.Tensor,
                   n_slices: int = _WIDE_SLICES,
                   bits: int = _WIDE_BITS) -> torch.Tensor:
    """Exact float64 ``a @ b`` for small-K, wide-output contractions
    (kernel K3).

    ``a: (m, K)`` small (reduced eigenvectors, an overlap), ``b: (K, n)``
    wide (the expansion space).  Both are put on their power-of-two grids
    (a per row, b per column) and sliced into 8 int8 planes on the card, in
    one call of two launches (a's side, then everything on b), reading a
    and b in place through their strides; every plane product is an exact
    int32 level sum on the int8 tensor cores.  Accuracy: both operands
    truncated 2^-55 below their row / column scales, no rounding inside the
    contraction.  On CPU tensors this is :func:`sliced_wide_mm_plain`,
    which takes any (``n_slices``, ``bits``) within the int32 bound; on
    CUDA tensors it launches ``csrc/wide_mm.cu`` (bit-identical), whose
    shape is fixed at 8 planes of 7 bits, or raises.
    """
    _wide_check(a, b, bits)
    if a.device.type == "cpu":
        return sliced_wide_mm_plain(a, b, n_slices, bits)
    if a.device.type != "cuda":
        raise ValueError(f"sliced_wide_mm: unsupported device {a.device}")
    if (n_slices, bits) != (_WIDE_SLICES, _WIDE_BITS):
        raise ValueError(
            f"sliced_wide_mm: kernel K3 (csrc/wide_mm.cu) is built for "
            f"{_WIDE_SLICES} planes of {_WIDE_BITS} bits, not n_slices="
            f"{n_slices}, bits={bits}; pass CPU tensors for the plain "
            "version")
    m, kdim = a.shape
    n = b.shape[1]
    # the kernel's grid covers 16 rows a CTA in y (at most 65535 CTAs) and
    # takes its sizes as int32
    if -(-m // _WIDE_ROWS) > 65535 or n >= 2 ** 31:
        raise ValueError(f"sliced_wide_mm: shapes too large ({m}, {kdim}, "
                         f"{n})")
    out = torch.empty((m, n), dtype=torch.float64, device=a.device)
    if m == 0 or n == 0:
        return out
    # the raw handle: torch.cuda.current_stream() costs microseconds of a
    # call this short
    stream = torch._C._cuda_getCurrentRawStream(a.device.index)
    scratch = _wide_scratch(a.device, stream, _wide_scratch_bytes(m, kdim))
    lib = _wide_lib()
    err = lib.wide_mm(a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
                      b.stride(0), b.stride(1), out.data_ptr(),
                      scratch.data_ptr(), m, kdim, n, stream)
    if err:
        raise RuntimeError(
            f"wide_mm kernel: {lib.wide_mm_error_string(err).decode()}")
    sliced_wide_mm.launches += 1
    return out


sliced_wide_mm.launches = 0

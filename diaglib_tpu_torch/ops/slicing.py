"""Ozaki-style integer slices of floating-point operands (port of
``diaglib_tpu/ops/slicing.py``, the parts the sliced matvec needs).

A row of x is put on a power-of-two grid and peeled into int8 planes,

    x[m, :] = scale_m * sum_i q_i[m, :] * 2^{-bits*(i+1)},   q_i integer,

so that products of planes are exact int8 x int8 -> int32 sums and the
float result is an exactly weighted sum of them.  Every step of the peel
is exact float32 arithmetic on the (hi, mid, lo) float32 triple of a
float64 value, so the planes are integers that any correct implementation
reproduces bit for bit.

:func:`peel_rows` is the wrapper of the CUDA kernel ``csrc/peel.cu``; on a
CPU tensor it runs :func:`peel_rows_plain`, the same chain in torch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["pow2_grid", "slice_operand", "slice_scaled",
           "slice_scaled_components", "combine_weights", "peel_rows",
           "peel_rows_plain"]

_BITS = 6
_SLICES = 9  # 54 bits >= f64's 53-bit mantissa


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
        for name in ("peel_f64", "peel_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, i64, i32, i32, p]
            fn.restype = i32
        lib.peel_f32x3.argtypes = [p, p, p, p, i64, i32, i32, p]
        lib.peel_f32x3.restype = i32
        lib.peel_error_string.argtypes = [i32]
        lib.peel_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def peel_rows(t_or_components, nx: int, bits: int) -> torch.Tensor:
    """``(nx,) + shape`` int8 planes of pre-scaled values (kernel K2).

    ``t_or_components`` is a float64 or float32 tensor ``t`` with
    |t| <= 1/2, or a (hi, mid, lo) tuple of float32 tensors.  On the CPU
    this is :func:`peel_rows_plain`; on a CUDA tensor it launches
    ``csrc/peel.cu`` (bit-identical) or raises.
    """
    comps = t_or_components if isinstance(t_or_components, tuple) else None
    first = comps[0] if comps is not None else t_or_components
    if first.device.type == "cpu":
        return peel_rows_plain(t_or_components, nx, bits)
    if first.device.type != "cuda":
        raise ValueError(f"peel_rows: unsupported device {first.device}")
    if nx <= 0 or bits * nx >= 127:
        raise ValueError(f"peel_rows: nx={nx} planes of {bits} bits")
    if comps is not None:
        if (len(comps) != 3 or any(c.dtype != torch.float32 for c in comps)
                or any(c.shape != first.shape or c.device != first.device
                       for c in comps)):
            raise ValueError("peel_rows: components must be three float32 "
                             "tensors of one shape on one device")
        comps = tuple(c.contiguous() for c in comps)
    elif first.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"peel_rows: unsupported dtype {first.dtype}")
    else:
        first = first.contiguous()
    out = torch.empty((nx,) + tuple(first.shape), dtype=torch.int8,
                      device=first.device)
    numel = first.numel()
    lib = _peel_lib()
    stream = torch.cuda.current_stream(first.device).cuda_stream
    if comps is not None:
        err = lib.peel_f32x3(comps[0].data_ptr(), comps[1].data_ptr(),
                             comps[2].data_ptr(), out.data_ptr(), numel, nx,
                             bits, stream)
    elif first.dtype == torch.float64:
        err = lib.peel_f64(first.data_ptr(), out.data_ptr(), numel, nx, bits,
                           stream)
    else:
        err = lib.peel_f32(first.data_ptr(), out.data_ptr(), numel, nx, bits,
                           stream)
    if err:
        raise RuntimeError(
            f"peel kernel: {lib.peel_error_string(err).decode()}")
    peel_rows.launches += 1
    return out


peel_rows.launches = 0


def slice_operand(x: torch.Tensor, n_slices: int = _SLICES,
                  bits: int = _BITS):
    """Row-aligned int8 planes of 2-D ``x`` on a per-row power-of-two grid.

    Returns ``(planes, scale)``: ``planes`` is ``(n_slices, k, n)`` int8,
    ``scale`` is ``(k, 1)`` float64, and
    ``x ~= scale * sum_i planes[i] * 2^{-bits*(i+1)}`` to
    ``2^{-bits*n_slices}`` of each row's max.  At ``bits >= 7`` the grid is
    doubled (|t| <= 1/2) so the top plane stays inside int8.  Float32 ``x``
    is peeled from float32 (mid = lo = 0), float64 from its triple.
    """
    scale = pow2_grid(x.abs().amax(dim=-1, keepdim=True))
    if bits >= 7:
        scale = 2.0 * scale
    # exact: a power-of-two division, done in float64 so that no float32
    # reciprocal of a tiny grid overflows
    t = (x.to(torch.float64) / scale).to(x.dtype)
    return peel_rows(t, n_slices, bits), scale


def combine_weights(n_levels: int, bits: int = _BITS,
                    dtype=torch.float64, device=None) -> torch.Tensor:
    """(n_levels,) weights 2^{-bits*(L+2)} for level-summed plane products."""
    return torch.tensor([2.0 ** (-bits * (lev + 2))
                         for lev in range(n_levels)], dtype=dtype,
                        device=device)

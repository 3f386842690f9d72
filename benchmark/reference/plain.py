"""Plain PyTorch arithmetic of the reference: block-sparse products and the
lowest eigenpairs of a symmetric definite pencil by a textbook block
Davidson method.

Nothing here imports the program under test.  It works from the
benchmark's own blocks (``blocks_t[e]`` is block (rows[e],
cols[e]) transposed, as the generators in ``benchmark/inputs`` store it),
in the dtype the caller asks for: float64 for the reference, float32 for
the control.
"""

from __future__ import annotations

import torch

CHUNK = 128          # block entries a batched product


def bsr_product(a: dict, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ A^T`` (rows of x are vectors) for the block-sparse A in
    ``a``, in x's dtype: each block is cast to it, a chunk at a time."""
    B, n = a["block"], a["n"]
    nbr = n // B
    k = x.shape[0]
    xb = x.reshape(k, nbr, B).transpose(0, 1)                # (nbr, k, B)
    y = torch.zeros((nbr, k, B), dtype=x.dtype, device=x.device)
    rows, cols, blocks = a["rows"].long(), a["cols"].long(), a["blocks_t"]
    for s in range(0, blocks.shape[0], CHUNK):
        e = slice(s, s + CHUNK)
        y.index_add_(0, rows[e], xb[cols[e]] @ blocks[e].to(x.dtype))
    return y.transpose(0, 1).reshape(k, n)


def bsr_diagonal(a: dict) -> torch.Tensor:
    """The diagonal of A, in float64."""
    B = a["block"]
    on = (a["rows"] == a["cols"]).nonzero().flatten()
    d = torch.empty(a["n"], dtype=torch.float64, device=a["blocks_t"].device)
    blocks = a["blocks_t"][on].double().diagonal(dim1=1, dim2=2)
    for i, r in enumerate(a["rows"][on].tolist()):
        d[r * B:(r + 1) * B] = blocks[i]
    return d


def _orthonormal(t: torch.Tensor, basis: torch.Tensor | None) -> torch.Tensor:
    """Rows of t made orthonormal and orthogonal to the rows of basis (two
    passes of Gram-Schmidt, then QR)."""
    for _ in range(2):
        if basis is not None and basis.shape[0]:
            t = t - (t @ basis.T) @ basis
        q, _ = torch.linalg.qr(t.T)
        t = q.T.contiguous()
    return t


def lowest_pairs(apply_a, apply_b, diag_a, diag_b, n: int, k: int, *,
                 dtype, device, seed: int, extra: int = 10,
                 max_basis: int = 120, rel_tol: float = 1e-9,
                 max_iter: int = 300):
    """The k lowest eigenpairs of ``A x = theta B x`` (A symmetric, B
    symmetric positive definite; ``apply_b`` None for B = I): block
    Davidson with Rayleigh-Ritz on an orthonormal basis, the diagonal
    preconditioner ``r / (diag_a - theta diag_b)``, ``k + extra`` vectors
    a block, restarts from the block's Ritz vectors.  It starts, as
    Davidson codes do, from the unit vectors of the rows with the least
    ``diag_a / diag_b``, each with a seeded random tenth added: a random
    start alone lets the preconditioner, which amplifies the rows near
    the current Ritz values, settle on the bulk of the spectrum before it
    finds separated low modes.  Stops when every wanted pair's ||r|| <=
    rel_tol |theta| ||B x|| or after ``max_iter`` iterations.  Returns
    ``(theta, X, iterations)``: X's rows B-orthonormal."""
    m = k + extra
    gen = torch.Generator(device=device).manual_seed(seed)
    da = diag_a.to(dtype)
    db = diag_b.to(dtype) if diag_b is not None else None
    ratio = diag_a / diag_b if diag_b is not None else diag_a
    rows = torch.argsort(ratio)[:m]
    start = torch.randn((m, n), generator=gen, dtype=torch.float64,
                        device=device)
    start *= 0.1 / start.norm(dim=1, keepdim=True)
    start[torch.arange(m, device=device), rows] += 1.0
    v = _orthonormal(start.to(dtype), None)
    av = apply_a(v)
    bv = apply_b(v) if apply_b is not None else v
    it = 0
    while True:
        h = v @ av.T
        h = 0.5 * (h + h.T)
        if apply_b is None:
            # the basis is orthonormal: the Rayleigh quotient as it stands
            theta, y = torch.linalg.eigh(h)
        else:
            s = v @ bv.T
            s = 0.5 * (s + s.T)
            chol = torch.linalg.cholesky(s)
            c = torch.linalg.solve_triangular(chol, h, upper=False)
            c = torch.linalg.solve_triangular(chol, c.T, upper=False).T
            theta, z = torch.linalg.eigh(0.5 * (c + c.T))
            y = torch.linalg.solve_triangular(chol.T, z, upper=True)
        y = y[:, :m]
        theta = theta[:m]
        x, ax, bx = y.T @ v, y.T @ av, y.T @ bv
        r = ax - theta[:, None] * bx
        res = r.norm(dim=1) / (theta.abs() * bx.norm(dim=1))
        it += 1
        if bool((res[:k] <= rel_tol).all()) or it >= max_iter:
            return theta[:k], x[:k], it
        den = da[None, :] - theta[:, None] * (db[None, :] if db is not None
                                              else 1.0)
        tiny = torch.finfo(dtype).eps * da.abs().max()
        den = torch.where(den.abs() < tiny, tiny, den)
        t = r / den
        if v.shape[0] + m > max_basis:
            v = _orthonormal(x, None)
            av = apply_a(v)
            bv = apply_b(v) if apply_b is not None else v
        t = _orthonormal(t, v)
        v = torch.cat([v, t])
        av = torch.cat([av, apply_a(t)])
        bv = torch.cat([bv, apply_b(t) if apply_b is not None else t])

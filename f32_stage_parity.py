#!/usr/bin/env python3
"""Where the float32 Davidson stages of the JAX package and of the port
part, on the CPU.

    JAX_PLATFORMS=cpu python3 f32_stage_parity.py

The operator is the JAX package's ``random_bsr_spd(1024, 128, 4)`` (key 0),
sliced by ``slice_bsr_sym`` and carried to the port with
``sym_store_from_arrays``; both packages get the same numpy guesses.
Printed:

1. step by step, on one guess: the guess overlap (check_guess's float32
   Gram), check_guess's result, the float32 sliced matvec (K1's plain
   version against the JAX kernel in interpret mode), and the reduced
   matrix row block ``mmT(A V, V)`` of the first iteration, each as the
   largest difference between the packages and, for the Gram products,
   each package's largest error against a float64 product of the same
   float32 operands;
2. both float32 stages' largest rms over the 10 targeted roots, iteration
   by iteration, on that guess;
3. the ladder's total and float64-stage iteration counts of both packages
   at the flagship options (10 roots, n_max 15, tol 1e-10, max_dav 10,
   lo_tol 2e-6, lo_iter 35) on 8 guesses: numpy uniform in [-0.5, 0.5)
   and standard normal, seeds 0-3.
"""

from __future__ import annotations

import dataclasses

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from diaglib_tpu import SolverOptions as JOptions  # noqa: E402
from diaglib_tpu.ops import bsr_sliced_sym as jsym  # noqa: E402
from diaglib_tpu.ops.bsr import random_bsr_spd as j_random  # noqa: E402
from diaglib_tpu.problems import diag_precnd as j_pc  # noqa: E402
from diaglib_tpu.solvers import davidson as j_davidson  # noqa: E402
from diaglib_tpu.solvers import davidson_ladder as j_ladder  # noqa: E402
from diaglib_tpu.utils import mm as jmm  # noqa: E402
from diaglib_tpu.utils.guess import check_guess as j_check  # noqa: E402
from diaglib_tpu_torch import SolverOptions, davidson  # noqa: E402
from diaglib_tpu_torch import davidson_ladder  # noqa: E402
from diaglib_tpu_torch.ops.bsr_sliced_sym import (  # noqa: E402
    sym_sliced_matvec,
    sym_store_from_arrays,
)
from diaglib_tpu_torch.problems import diag_precnd  # noqa: E402
from diaglib_tpu_torch.utils import mm as tmm  # noqa: E402
from diaglib_tpu_torch.utils.guess import check_guess  # noqa: E402

j_slice, j_mv = jsym.slice_bsr_sym, jsym.sym_sliced_matvec

N, B, BPR, N_TARG, N_MAX = 1024, 128, 4, 10, 15
OPTS = dict(n_targ=N_TARG, n_max=N_MAX, max_iter=150, tol=1e-10, max_dav=10)
LADDER = dict(lo_tol=2e-6, lo_iter=35)


def _guess(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-0.5, 0.5, (N_MAX, N))
    return rng.standard_normal((N_MAX, N))


def _gram_errors(t, j, a, b):
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    return (float(np.max(np.abs(t - j))), float(np.max(np.abs(t - exact))),
            float(np.max(np.abs(j - exact))), float(np.max(np.abs(exact))))


def steps(js, ts, g):
    g32 = g.astype(np.float32)
    d, te, je, scale = _gram_errors(
        tmm.mmT(torch.from_numpy(g32), torch.from_numpy(g32)).numpy(),
        np.asarray(jmm.mmT(jnp.asarray(g32), jnp.asarray(g32))), g32, g32)
    print(f"[steps] guess overlap (float32 mmT): port - JAX {d:.3e}; error "
          f"against float64 port {te:.3e}, JAX {je:.3e} (max {scale:.3e})")
    v_t = check_guess(torch.from_numpy(g32)).numpy()
    v_j = np.array(j_check(jnp.asarray(g32), jax.random.PRNGKey(1)))
    print(f"[steps] check_guess (ortho_cd of the guess): port - JAX "
          f"{np.max(np.abs(v_t - v_j)):.3e}")
    y_t = sym_sliced_matvec(ts, dtype=torch.float32)(torch.from_numpy(v_j))
    y_j = np.array(j_mv(js, dtype=jnp.float32, interpret=True)(
        jnp.asarray(v_j)))
    print(f"[steps] float32 sliced matvec on the same V: bit-equal "
          f"{np.array_equal(y_t.numpy(), y_j)}")
    d, te, je, scale = _gram_errors(
        tmm.mmT(torch.from_numpy(y_j), torch.from_numpy(v_j)).numpy(),
        np.asarray(jmm.mmT(jnp.asarray(y_j), jnp.asarray(v_j))), y_j, v_j)
    print(f"[steps] reduced rows mmT(A V, V) on the same inputs: port - JAX "
          f"{d:.3e}; error against float64 port {te:.3e}, JAX {je:.3e} "
          f"(max {scale:.3e})")


def stage_rms(js, ts, g):
    kw = dict(OPTS, max_iter=LADDER["lo_iter"], tol=LADDER["lo_tol"])
    r = davidson(sym_sliced_matvec(ts, dtype=torch.float32),
                 diag_precnd(ts.diagonal.to(torch.float32)),
                 torch.from_numpy(g).float(), SolverOptions(**kw))
    j = j_davidson(j_mv(js, dtype=jnp.float32, interpret=True),
                   j_pc(js.diagonal.astype(jnp.float32)),
                   jnp.asarray(g, jnp.float32), JOptions(**kw),
                   key=jax.random.PRNGKey(1))
    rt = r.rms_history.numpy()[:, :N_TARG]
    rj = np.asarray(j.rms_history)[:, :N_TARG]
    print(f"[stage] float32 stage iterations: port {r.n_iter}, JAX "
          f"{int(j.n_iter)}")
    for it in range(max(r.n_iter, int(j.n_iter))):
        a = np.where(np.isfinite(rt[it]), rt[it], 0.0)
        b = np.where(np.isfinite(rj[it]), rj[it], 0.0)
        print(f"[stage] it {it:2d} max rms port {a.max():.9e} JAX "
              f"{b.max():.9e}")


def counts(js, ts):
    lo = (j_mv(js, dtype=jnp.float32, interpret=True),
          j_pc(js.diagonal.astype(jnp.float32)), j_mv(js, interpret=True),
          j_pc(js.diagonal))
    tl = (sym_sliced_matvec(ts, dtype=torch.float32),
          diag_precnd(ts.diagonal.to(torch.float32)), sym_sliced_matvec(ts),
          diag_precnd(ts.diagonal))

    def f64_iters(h):
        return int(np.isfinite(np.asarray(h)[:, 0]).sum())

    for kind in ("uniform", "normal"):
        for seed in range(4):
            g = _guess(kind, seed)
            r = davidson_ladder(*tl, torch.from_numpy(g),
                                SolverOptions(**OPTS), **LADDER)
            j = j_ladder(*lo, jnp.asarray(g), JOptions(**OPTS),
                         key=jax.random.PRNGKey(1), **LADDER)
            d = float(np.max(np.abs(r.eig[:N_TARG].numpy()
                                    - np.asarray(j.eig[:N_TARG]))))
            print(f"[ladder] {kind} seed {seed}: port {r.n_iter} (f64 "
                  f"{f64_iters(r.rms_history)}), JAX {int(j.n_iter)} (f64 "
                  f"{f64_iters(j.rms_history)}), ok {r.ok} {bool(j.ok)}, "
                  f"eigenvalues {d:.1e} apart")


def main():
    torch.set_num_threads(1)
    jm = j_random(N, B, BPR, jax.random.PRNGKey(0),
                          dtype=jnp.float32)
    js = j_slice(jm)
    ts = sym_store_from_arrays({f.name: np.asarray(getattr(js, f.name))
                                for f in dataclasses.fields(js)},
                               device="cpu")
    g = _guess("normal", 0)
    steps(js, ts, g)
    stage_rms(js, ts, g)
    counts(js, ts)


if __name__ == "__main__":
    main()

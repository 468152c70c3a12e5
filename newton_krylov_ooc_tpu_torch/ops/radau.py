"""adaptive Radau IIA (order 5) stiff ODE integrator in PyTorch, dense and
banded.

Port of newton_krylov_ooc_tpu/ops/radau.py: the classic RADAU5 method
(Hairer & Wanner, "Solving ODEs II", ch. IV.8) with LU stage solves (one
real and one complex system), Jacobian and LU reuse, the
embedded order-3 error estimator, the predictive (Gustafsson) step-size
controller, and output at t_eval from the collocation polynomial.  It makes
the JAX integrator's decisions in the same order: its step attempts, its
tendency evaluations and its LUs (NEWTON_MAXITER, lu_reuse_factor).

The JAX integrator branches with ``lax.cond`` inside a ``lax.while_loop``.
On a card a read of a flag costs a sync, so a step attempt is written as
fixed-shape, branch-free stages over the integrator's state, each
``lax.cond`` computing both outcomes and selecting with ``torch.where``, the
LUs without a read-back:

- a fast attempt refactors its LUs where they are stale, runs
  FAST_NEWTON_ITERS collocation Newton iterations (a converged mask freezes
  the iterate) and, when they settle it, the error estimate and the
  accept / reject / halve decision;
- work that few attempts need waits for a service stage: an attempt that
  needs more Newton iterations stalls, and an attempt that refreshes the
  Jacobian leaves it pending; `_finish` runs the remaining Newton
  iterations and the decision, `_refresh_jac` the Jacobian.

A stalled or finished state makes the fast attempts no-ops, so a run of
ATTEMPTS_PER_REPLAY of them may overshoot.  On a card each stage is
captured once in a CUDA graph; the host replays the run of fast attempts,
reads one small flag vector, and replays the service stages it names.  On
the CPU the same stages run eagerly, every branch computed as on a card.
States are flat (n,) vectors.

Dense mode: the Jacobian is a dense (n, n) matrix, by forward-mode AD with
its n unit tangents as one batch (the JAX integrator takes jax.jacfwd), or
the caller's `jac`; the LUs go through ``torch.linalg.lu_factor_ex`` and
``lu_solve``.  Banded mode (``jac_bands``, ``bandwidth``): the Jacobian is
the caller's analytic row-band blocks (n_blocks, m, 2bw+1), block-diagonal
over e.g. tracers and banded within, and the stage systems take the
pivot-free banded LU of ops/banded.py natively in complex for the complex
one, as the JAX integrator does off the TPU.  The state then keeps the
factored real and complex bands in place of the dense LUs and pivots; on a
card the factor and the solves are the hand-written kernel
(csrc/banded_lu.cu), the two systems' factors in one launch and a Newton
iteration's two solves in another.  Each stage's factors and solves are
launched on every replay and read a device flag (stale LUs, a live Newton
iteration, a converged attempt's error estimate): the work the attempt
does not need returns at once, and its masked result is not used; the CPU
skips the same work on the same flags.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc

import numpy as np
import torch
import torch.autograd.forward_ad as fwad

from . import banded_cuda
from .banded import (
    banded_lu_factor_pair,
    banded_lu_solve_blocks,
    banded_lu_solve_pair,
    bands_add_diag,
)

# -- collocation constants (float64 numpy, derived at import) -----------------

_S6 = np.sqrt(6.0)
_C = np.array([(4.0 - _S6) / 10.0, (4.0 + _S6) / 10.0, 1.0])

# Butcher matrix A from the collocation conditions: A @ V = W with
# V[j, k] = c_j^k and W[i, k] = c_i^(k+1) / (k+1)  (exact for degree<=2)
_V = np.vander(_C, 3, increasing=True)
_W = np.stack([_C ** (k + 1) / (k + 1) for k in range(3)], axis=1)
_A = _W @ np.linalg.inv(_V)
_AINV = np.linalg.inv(_A)

# real canonical form of A^-1: one real eigenvalue and a complex pair
_eigvals, _eigvecs = np.linalg.eig(_AINV)
_real_ind = int(np.argmin(np.abs(_eigvals.imag)))
_cplx_ind = [i for i in range(3) if i != _real_ind and _eigvals[i].imag > 0][0]
MU_REAL = float(_eigvals[_real_ind].real)
_v_real = _eigvecs[:, _real_ind].real
_v_cplx = _eigvecs[:, _cplx_ind]
_T = np.stack([_v_real, _v_cplx.real, _v_cplx.imag], axis=1)
_TI = np.linalg.inv(_T)
_M = _TI @ _AINV @ _T
# complex shift: rows 1,2 of M form [[a, b], [-b, a]] acting on (W1, W2);
# combining w = W1 + i*W2 yields one complex system with mu = M11 + i*M21
MU_COMPLEX = complex(_M[1, 1], _M[2, 1])
if abs(_M[0, 0] - MU_REAL) > 1e-10 or abs(_M[1, 1] - _M[2, 2]) > 1e-10:
    raise ArithmeticError("Radau IIA canonical form is not block diagonal")

# embedded order-3 error estimator weights (Hairer & Wanner, RADAU5)
_E = np.array([-13.0 - 7.0 * _S6, -13.0 + 7.0 * _S6, -1.0]) / 3.0

# continuous-extension coefficients: z(x) = (z.T @ _P) @ [x, x^2, x^3] with
# x = (t - t_old)/h interpolates the stage increments (z(c_i) = z_i, z(0) = 0)
_P = np.linalg.inv(np.stack([_C ** (k + 1) for k in range(3)], axis=1)).T

NEWTON_MAXITER = 6
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0

# collocation Newton iterations of a fast attempt; a test_problem year
# averages about two
FAST_NEWTON_ITERS = 2
# fast attempts captured in one CUDA graph (run between flag reads on the CPU)
ATTEMPTS_PER_REPLAY = 2

# the stages, each captured in a graph of its own on a card
STAGES = ("attempts", "finish", "refresh_jac")

LU_KEYS = ("lu_r", "piv_r", "lu_c", "piv_c")
BANDED_LU_KEYS = ("lu_r", "lu_c")


def _rms_norm(x):
    return torch.sqrt(torch.mean(torch.square(x)))


def _predict_factor(h_abs, h_abs_old, error_norm, error_norm_old):
    """Gustafsson predictive step factor (order-3 error estimator)"""
    have_old = (h_abs_old > 0) & (error_norm_old >= 0) & (error_norm > 0)
    multiplier = torch.where(
        have_old,
        h_abs
        / torch.where(h_abs_old > 0, h_abs_old, 1.0)
        * (
            torch.where(error_norm_old >= 0, error_norm_old, 1.0)
            / torch.where(error_norm > 0, error_norm, 1.0)
        )
        ** 0.25,
        1.0,
    )
    err = torch.clamp(error_norm, min=1e-30)
    return torch.clamp(multiplier, max=1.0) * err ** -0.25


def forward_jacobian(fun, t, y):
    """the dense Jacobian of fun(t, .) at y by forward-mode AD: the n unit
    tangents as one batch of n evaluations (fun broadcasts over a leading
    batch axis), so it needs neither torch.func nor a loop over columns"""
    n = y.shape[-1]
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    with fwad.dual_level():
        dual = fwad.make_dual(y.expand(n, n).clone(), eye)
        tangent = fwad.unpack_dual(fun(t.expand(n), dual)).tangent
    if tangent is None:  # fun does not depend on y
        return torch.zeros_like(eye)
    return tangent.T


class Radau5:
    """Radau IIA(5) for one problem: fun, n, t_eval, dtype, device

    fun(t, y) -> dy/dt must broadcast over a leading batch axis: it is called
    with t of shape () and y of shape (n,), and with t of shape (B,) and y of
    shape (B, n) (the three collocation stages in one call).  It must be free
    of host reads and data-dependent Python branches: it is differentiated
    by forward-mode AD and, on a card, captured in a CUDA graph.
    jac(t, y) -> (n, n) defaults to forward_jacobian(fun, t, y).
    jac_bands(t, y) -> (n_blocks, m, 2*bandwidth+1) with n_blocks * m == n
    selects the banded mode (bandwidth is required with it); it is called
    with t of shape () and y of shape (n,).

    `integrate(y0)` may be called many times; the state lives in fixed
    buffers, and on a card the stages' graphs are captured at the first
    call and replayed after.
    """

    def __init__(
        self,
        fun,
        n,
        t_span,
        t_eval,
        *,
        device,
        dtype=torch.float64,
        jac=None,
        rtol=1e-6,
        atol=1e-6,
        max_step=np.inf,
        max_attempts=1_000_000,
        lu_reuse_factor=1.2,
        jac_bands=None,
        bandwidth=None,
    ):
        self.fun = fun
        self.n = int(n)
        self.dtype = dtype
        self.device = torch.device(device)
        self.cplx_dtype = (
            torch.complex128 if dtype == torch.float64 else torch.complex64
        )
        self.banded = jac_bands is not None
        if self.banded:
            if bandwidth is None:
                raise ValueError("bandwidth is required with jac_bands")
            self.bandwidth = int(bandwidth)
            self.jac = jac_bands
            self.lu_keys = BANDED_LU_KEYS
        else:
            self.jac = (functools.partial(forward_jacobian, fun) if jac is None
                        else jac)
            self.lu_keys = LU_KEYS
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_step = float(max_step)
        self.has_max_step = bool(np.isfinite(self.max_step))
        self.max_attempts = int(max_attempts)
        self.lu_reuse_factor = float(lu_reuse_factor)

        def tensor(arr):
            return torch.as_tensor(np.asarray(arr, dtype=np.float64), dtype=dtype,
                                   device=self.device)

        self.t0 = tensor(float(t_span[0]))
        self.t_end = tensor(float(t_span[1]))
        self.t_eval = tensor(t_eval)
        self.c_arr = tensor(_C)
        self.e_arr = tensor(_E)
        self.t_mat = tensor(_T)
        self.ti_mat = tensor(_TI)
        self.p_mat = tensor(_P)
        self.eye = torch.eye(self.n, dtype=dtype, device=self.device)
        self.eye_c = torch.eye(self.n, dtype=self.cplx_dtype, device=self.device)
        self.mu_c = torch.tensor(MU_COMPLEX, dtype=self.cplx_dtype, device=self.device)
        self.eps = float(torch.finfo(dtype).eps)
        self.newton_tol = max(10 * self.eps / self.rtol, min(0.03, self.rtol ** 0.5))

        self.state = None  # fixed buffers, allocated at the first integrate
        self.graphs = None  # stage name -> CUDA graph (on a card)
        # stage name -> (factor, solve) banded-kernel launches in its graph
        self.graph_launches = {}
        self.runs = collections.Counter()  # stage name -> runs, all years

    # -- linear algebra ----------------------------------------------------------

    def _shifted_bands(self, h, jac_mat):
        """the real and complex stage matrices (MU_REAL/h I - J) and
        (MU_COMPLEX/h I - J) of banded J"""
        neg = -jac_mat
        return (bands_add_diag(neg, MU_REAL / h),
                bands_add_diag(neg.to(self.cplx_dtype),
                               self.mu_c / h.to(self.cplx_dtype)))

    def _factor_lu(self, h, jac_mat):
        """the stage LUs, in the order of self.lu_keys"""
        if self.banded:
            return banded_lu_factor_pair(*self._shifted_bands(h, jac_mat))
        lu_r, piv_r, _ = torch.linalg.lu_factor_ex(MU_REAL / h * self.eye - jac_mat)
        lu_c, piv_c, _ = torch.linalg.lu_factor_ex(
            self.mu_c / h.to(self.cplx_dtype) * self.eye_c
            - jac_mat.to(self.cplx_dtype)
        )
        return lu_r, piv_r, lu_c, piv_c

    def _solve_lu(self, st, part, rhs, active):
        """solve the real (part "r") or complex ("c") stage system; banded,
        only where `active` (the result is masked elsewhere: the kernel
        returns rhs unsolved)"""
        lu = st["lu_" + part]
        if self.banded:
            n_blocks = lu.shape[0]
            return banded_lu_solve_blocks(lu, rhs.reshape(n_blocks, -1),
                                          active=active).reshape(-1)
        return torch.linalg.lu_solve(lu, st["piv_" + part],
                                     rhs.unsqueeze(-1)).squeeze(-1)

    def _solve_stages(self, st, rhs_real, rhs_c, active):
        """a Newton iteration's real and complex stage systems: banded, in
        one launch of the kernel on a card (the real one, then the complex
        one on the CPU), only where `active`"""
        if not self.banded:
            return (self._solve_lu(st, "r", rhs_real, active),
                    self._solve_lu(st, "c", rhs_c, active))
        n_blocks = st["lu_r"].shape[0]
        x_r, x_c = banded_lu_solve_pair(
            st["lu_r"], rhs_real.reshape(n_blocks, -1), st["lu_c"],
            rhs_c.reshape(n_blocks, -1), active=active)
        return x_r.reshape(-1), x_c.reshape(-1)

    # -- initial state -----------------------------------------------------------

    def _initial_state(self, y0):
        """the JAX integrator's initial step size, Jacobian and LUs"""
        fun, rtol, atol = self.fun, self.rtol, self.atol
        t0, t_end, dtype = self.t0, self.t_end, self.dtype
        f0 = fun(t0, y0)
        scale0 = atol + torch.abs(y0) * rtol
        d0 = _rms_norm(y0 / scale0)
        d1 = _rms_norm(f0 / scale0)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
        y1 = y0 + h0 * f0
        f1 = fun(t0 + h0, y1)
        d2 = _rms_norm((f1 - f0) / scale0) / h0
        dmax = torch.maximum(d1, d2)
        h1 = torch.where(
            dmax <= 1e-15,
            torch.clamp(h0 * 1e-3, min=1e-6),
            (0.01 / dmax) ** 0.25,
        )
        h_init = torch.minimum(
            torch.minimum(100 * h0, h1),
            torch.clamp(t_end - t0, max=self.max_step),
        )
        jac0 = self.jac(t0, y0).to(dtype)
        if self.banded:
            width = 2 * self.bandwidth + 1
            if jac0.dim() != 3 or jac0.shape[-1] != width or \
                    jac0.shape[0] * jac0.shape[1] != self.n:
                raise ValueError(
                    f"jac_bands gave shape {tuple(jac0.shape)}; expected "
                    f"(n_blocks, m, {width}) with n_blocks * m == {self.n}")
        lus = dict(zip(self.lu_keys, self._factor_lu(
            torch.clamp(h_init, min=10 * self.eps), jac0
        )))

        def scalar(val, dt=dtype):
            return torch.as_tensor(val, dtype=dt, device=self.device)

        n_time = self.t_eval.shape[0]
        false = scalar(False, torch.bool)
        zero = scalar(0, torch.int64)
        return {
            "t": t0.clone(),
            "y": y0.clone(),
            "f": f0,
            "h_abs": h_init.to(dtype),
            "h_abs_old": scalar(-1.0),
            "error_norm_old": scalar(-1.0),
            "jac_mat": jac0,
            "current_jac": scalar(True, torch.bool),
            **lus,
            "need_lu": scalar(True, torch.bool),
            "have_sol": false.clone(),
            "cont_q": torch.zeros((self.n, 3), dtype=dtype, device=self.device),
            "cont_base": y0.clone(),
            "t_old": t0.clone(),
            "h_old": scalar(1.0),
            "rejected": false.clone(),
            "nfev": scalar(2, torch.int64),
            "nlu": scalar(1, torch.int64),
            "failed": false.clone(),
            "n_att": zero.clone(),
            "ys": y0.expand(n_time, self.n).clone(),
            # a stalled attempt's Newton carry, and a pending Jacobian's point
            "stalled": false.clone(),
            "nw_w": torch.zeros((3, self.n), dtype=dtype, device=self.device),
            "nw_z": torch.zeros((3, self.n), dtype=dtype, device=self.device),
            "nw_dw_norm_old": scalar(-1.0),
            "nw_rate": scalar(0.0),
            "nw_iter": zero.clone(),
            "jac_pending": false.clone(),
            "jac_t": t0.clone(),
            "jac_y": y0.clone(),
        }

    # -- the stages of an attempt ---------------------------------------------

    def _active(self, st):
        """an attempt is due: before t_end, not failed, within the budget"""
        return (st["t"] < self.t_end) & ~st["failed"] & (
            st["n_att"] < self.max_attempts
        )

    def _step(self, st):
        """the attempt's step from the state: (t_new, h, |h|, too_small)"""
        min_step = 10 * self.eps * torch.abs(st["t"])
        h_abs = torch.clamp(torch.maximum(st["h_abs"], min_step), max=self.max_step)
        too_small = st["h_abs"] < min_step
        t_new = torch.minimum(st["t"] + h_abs, self.t_end)
        h = t_new - st["t"]
        return t_new, h, torch.abs(h), too_small

    def _newton(self, st, h, carry, iters):
        """simplified Newton on the transformed collocation system over the
        iterations `iters`, masked after convergence or divergence

        carry: (w, z, dw_norm_old, rate, converged, diverged, n_iter)
        """
        fun, rtol, atol = self.fun, self.rtol, self.atol
        mu_a, mu_b = MU_COMPLEX.real, MU_COMPLEX.imag
        w, z, dw_norm_old, rate, converged, diverged, n_iter = carry
        scale = atol + torch.abs(st["y"]) * rtol
        ch = st["t"] + h * self.c_arr
        mu_real_h = MU_REAL / h
        for k in iters:
            active = ~converged & ~diverged
            f_stages = fun(ch, st["y"] + z)  # (3, n)
            finite = torch.all(torch.isfinite(f_stages))

            tif = self.ti_mat @ f_stages
            rhs_real = tif[0] - mu_real_h * w[0]
            rhs_c = torch.complex(
                tif[1] - (mu_a * w[1] - mu_b * w[2]) / h,
                tif[2] - (mu_b * w[1] + mu_a * w[2]) / h,
            )
            dw_real, dw_c = self._solve_stages(st, rhs_real, rhs_c, active)
            dw = torch.stack([dw_real, dw_c.real, dw_c.imag])

            dw_norm = _rms_norm(dw / scale)
            have_old = dw_norm_old >= 0
            rate_new = torch.where(
                have_old, dw_norm / torch.clamp(dw_norm_old, min=1e-300), rate
            )
            contraction = dw_norm / torch.clamp(1.0 - rate_new, min=1e-10)
            bad_rate = have_old & (
                (rate_new >= 1.0)
                | (rate_new ** (NEWTON_MAXITER - k) * contraction > self.newton_tol)
            )
            diverged_new = ~finite | bad_rate
            conv_now = ~diverged_new & (
                (dw_norm == 0) | (have_old & (rate_new * contraction < self.newton_tol))
            )

            step = active & ~diverged_new
            w = torch.where(step, w + dw, w)
            z = torch.where(step, self.t_mat @ w, z)
            dw_norm_old = torch.where(active, dw_norm, dw_norm_old)
            rate = torch.where(active, rate_new, rate)
            converged = converged | (active & conv_now)
            diverged = diverged | (active & diverged_new)
            n_iter = n_iter + active.to(n_iter.dtype)
        return w, z, dw_norm_old, rate, converged, diverged, n_iter

    def _decide(self, st, live, step, carry):
        """the end of an attempt whose Newton iterations are settled (where
        `live`): error estimate, accept / reject / halve / refresh, output

        A Jacobian the attempt needs is left pending at its point.
        """
        fun, rtol, atol, dtype = self.fun, self.rtol, self.atol, self.dtype
        t, y = st["t"], st["y"]
        t_new, h, h_abs_cur, too_small = step
        _w, z, _dwn, rate, converged, _div, n_iter = carry
        converged = converged & live

        # converged: error estimate, stabilised after a rejection
        y_new = y + z[-1]
        ze = (z.T @ self.e_arr) / h
        scale = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
        error = self._solve_lu(st, "r", st["f"] + ze, converged)
        error_norm = _rms_norm(error / scale)
        stabilise = converged & st["rejected"] & (error_norm > 1)
        # the stabilising and the accepted step's tendencies in one call
        f_stab, f_new = fun(torch.stack([t, t_new]), torch.stack([y + error, y_new]))
        error2 = self._solve_lu(st, "r", f_stab + ze, stabilise)
        error_norm = torch.where(stabilise, _rms_norm(error2 / scale), error_norm)
        safety = 0.9 * (2 * NEWTON_MAXITER + 1) / (
            2 * NEWTON_MAXITER + n_iter.to(dtype)
        )
        pf = _predict_factor(h_abs_cur, st["h_abs_old"], error_norm,
                             st["error_norm_old"])
        accept = converged & (error_norm <= 1)
        reject = converged & (error_norm > 1)
        halve = live & ~converged & st["current_jac"]
        refresh = live & ~converged & ~st["current_jac"]

        # accept: step-size growth, LU reuse window, Jacobian refresh
        recompute_jac = (n_iter > 2) & (rate > 1e-3)
        factor = torch.clamp(safety * pf, max=MAX_FACTOR)
        if self.has_max_step:
            factor = torch.minimum(factor, self.max_step / h_abs_cur)
        keep_lu = ~recompute_jac & (factor < self.lu_reuse_factor)
        factor = torch.where(keep_lu, 1.0, factor)

        # a Jacobian at (t, y) to refresh a non-converged attempt's, at
        # (t_new, y_new) when an accepted step recomputes it
        new_jac = refresh | (accept & recompute_jac)
        h_abs_next = torch.where(
            halve,
            h_abs_cur * 0.5,
            torch.where(
                reject,
                h_abs_cur * torch.clamp(safety * pf, min=MIN_FACTOR),
                torch.where(accept, h_abs_cur * factor, st["h_abs"]),
            ),
        )
        count = live.to(st["nfev"].dtype)
        new = {
            "t": torch.where(accept, t_new, t),
            "y": torch.where(accept, y_new, y),
            "f": torch.where(accept, f_new, st["f"]),
            "h_abs": h_abs_next,
            "h_abs_old": torch.where(accept, h_abs_cur, st["h_abs_old"]),
            "error_norm_old": torch.where(accept, error_norm, st["error_norm_old"]),
            "current_jac": torch.where(
                refresh, True, torch.where(accept, recompute_jac, st["current_jac"])
            ),
            "need_lu": torch.where(
                accept, ~keep_lu, halve | refresh | reject | st["need_lu"]
            ),
            "have_sol": st["have_sol"] | accept,
            "cont_q": torch.where(accept, z.T @ self.p_mat, st["cont_q"]),
            "cont_base": torch.where(accept, y, st["cont_base"]),
            "t_old": torch.where(accept, t, st["t_old"]),
            "h_old": torch.where(accept, h, st["h_old"]),
            "rejected": torch.where(accept, False, halve | reject | st["rejected"]),
            "nfev": st["nfev"] + count * 3 * n_iter + accept.to(count.dtype),
            "failed": st["failed"] | (live & too_small),
            "n_att": st["n_att"] + count,
            "jac_pending": st["jac_pending"] | new_jac,
            "jac_t": torch.where(new_jac, torch.where(converged, t_new, t),
                                 st["jac_t"]),
            "jac_y": torch.where(new_jac, torch.where(converged, y_new, y),
                                 st["jac_y"]),
        }

        # fill the output points an accepted step crossed from the degree-3
        # continuous extension (exact at the right node, x == 1)
        h_safe = torch.where(new["h_old"] != 0, new["h_old"], 1.0)
        xe = (self.t_eval - new["t_old"]) / h_safe
        xpe = torch.stack([xe, xe**2, xe**3])  # (3 powers, n_time)
        vals = new["cont_base"][None, :] + (new["cont_q"] @ xpe).T
        newly = (self.t_eval > t) & (self.t_eval <= new["t"])
        new["ys"] = torch.where(newly[:, None], vals, st["ys"])
        return new

    def _fast_attempt(self, st):
        """an attempt with its LUs refactored if stale and FAST_NEWTON_ITERS
        Newton iterations: decided when they settle it, else stalled with
        its Newton carry; a no-op when the run is over, stalled, or waiting
        for a Jacobian"""
        go = self._active(st) & ~st["stalled"] & ~st["jac_pending"]
        step = self._step(st)
        h = step[1]

        # stage predictor from the last step's collocation polynomial
        x = (st["t"] + h * self.c_arr - st["t_old"]) / torch.where(
            st["h_old"] != 0, st["h_old"], 1.0
        )
        xp = torch.stack([x, x**2, x**3])  # (3 powers, 3 stages)
        y_poly = st["cont_base"][:, None] + st["cont_q"] @ xp  # (n, 3)
        z0 = torch.where(st["have_sol"], (y_poly - st["y"][:, None]).T, 0.0)

        refactored = self._refactored(st, go, h)
        st = {**st, **refactored}
        no = torch.zeros_like(go)
        # an attempt that is not due starts settled: its Newton iterations
        # are masked (and, banded, their solves skipped)
        carry = (self.ti_mat @ z0, z0, torch.full_like(h, -1.0),
                 torch.zeros_like(h), no, ~go, torch.zeros_like(st["n_att"]))
        carry = self._newton(st, h, carry, range(FAST_NEWTON_ITERS))
        settled = carry[4] | carry[5]
        stall = go & ~settled
        w, z, dw_norm_old, rate, _conv, _div, n_iter = carry
        return {
            **refactored,
            **self._decide(st, go & settled, step, carry),
            "stalled": st["stalled"] | stall,
            "nw_w": torch.where(stall, w, st["nw_w"]),
            "nw_z": torch.where(stall, z, st["nw_z"]),
            "nw_dw_norm_old": torch.where(stall, dw_norm_old, st["nw_dw_norm_old"]),
            "nw_rate": torch.where(stall, rate, st["nw_rate"]),
            "nw_iter": torch.where(stall, n_iter, st["nw_iter"]),
        }

    def _attempts(self, st):
        """ATTEMPTS_PER_REPLAY fast attempts on the state buffers"""
        for _ in range(ATTEMPTS_PER_REPLAY):
            self._write(self._fast_attempt(st))

    def _finish(self, st):
        """the stalled attempt's remaining Newton iterations and decision"""
        live = st["stalled"]
        step = self._step(st)
        no = torch.zeros_like(live)
        carry = (st["nw_w"], st["nw_z"], st["nw_dw_norm_old"], st["nw_rate"],
                 no, ~live, st["nw_iter"])
        carry = self._newton(st, step[1], carry,
                             range(FAST_NEWTON_ITERS, NEWTON_MAXITER))
        self._write({**self._decide(st, live, step, carry), "stalled": no})

    def _refresh_jac(self, st):
        """the pending Jacobian"""
        pending = st["jac_pending"]
        jac_eval = self.jac(st["jac_t"], st["jac_y"]).to(self.dtype)
        self._write({
            "jac_mat": torch.where(pending, jac_eval, st["jac_mat"]),
            "jac_pending": torch.zeros_like(pending),
        })

    def _refactored(self, st, live, h):
        """the attempt's LUs, refactored at its step h where stale and `live`:
        dense, both outcomes computed and one selected; banded, factored in
        place into the state's buffers only where due (on a card the
        kernel reads the flag)"""
        due = st["need_lu"] & live
        if self.banded:
            new = {}
            banded_lu_factor_pair(*self._shifted_bands(h, st["jac_mat"]),
                                  out_r=st["lu_r"], out_c=st["lu_c"], due=due)
        else:
            new = {
                key: torch.where(due, val, st[key])
                for key, val in zip(self.lu_keys, self._factor_lu(h, st["jac_mat"]))
            }
        new["nlu"] = st["nlu"] + due.to(st["nlu"].dtype)
        new["need_lu"] = st["need_lu"] & ~due
        return new

    def _write(self, new):
        for key, val in new.items():
            self.state[key].copy_(val)

    # -- driver ------------------------------------------------------------------

    @contextlib.contextmanager
    def _linalg_backend(self):
        """on a card, route the LUs to cuSOLVER for the integration: the
        default heuristic sends complex systems to MAGMA, whose getrf reads
        back to the host and cannot be captured in a graph"""
        if self.device.type != "cuda":
            yield
            return
        saved = torch.backends.cuda.preferred_linalg_library()
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            yield
        finally:
            torch.backends.cuda.preferred_linalg_library(saved)

    def _stage(self, name):
        return getattr(self, "_" + name)

    def _capture(self):
        """record each stage in a CUDA graph, after a warm-up run of each on a
        side stream (library handles and workspaces are made outside
        capture); the garbage collector waits, so that no other object's
        memory is freed while a capture is open"""
        saved = {key: val.clone() for key, val in self.state.items()}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for name in STAGES:
                self._stage(name)(self.state)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._write(saved)
        graphs = {}
        gc.collect()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            for name in STAGES:
                # a capture records the banded kernels' launches without
                # running them: they count when the graph replays
                before = banded_cuda.launch_counts()
                graphs[name] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[name]):
                    self._stage(name)(self.state)
                after = banded_cuda.launch_counts()
                self.graph_launches[name] = tuple(
                    a - b for a, b in zip(after, before))
                banded_cuda.set_launch_counts(*before)
        finally:
            if gc_was_enabled:
                gc.enable()
        return graphs

    def _run(self, name):
        self.runs[name] += 1
        if self.graphs is not None:
            self.graphs[name].replay()
            banded_cuda.add_launches(*self.graph_launches[name])
        else:
            self._stage(name)(self.state)

    def _flags(self):
        """(finished, stalled, Jacobian pending) in one read"""
        st = self.state
        flags = torch.stack([~self._active(st), st["stalled"], st["jac_pending"]])
        return [bool(val) for val in flags.cpu()]

    def integrate(self, y0):
        """integrate from y0 over t_span; returns (ys, info)

        ys: (len(t_eval), n); info: success, nfev, nlu, t_final,
        h_abs_final and n_attempts as Python numbers
        """
        y0 = torch.as_tensor(y0, dtype=self.dtype, device=self.device).reshape(-1)
        if y0.shape[0] != self.n:
            raise ValueError(f"y0 has {y0.shape[0]} entries, expected {self.n}")
        with self._linalg_backend():
            init = self._initial_state(y0)
            if self.state is None:
                self.state = init
                if self.device.type == "cuda":
                    self.graphs = self._capture()
            self._write(init)

            finished, stalled, jac_pending = self._flags()
            while not finished:
                if stalled:
                    self._run("finish")
                    finished, stalled, jac_pending = self._flags()
                if jac_pending:
                    self._run("refresh_jac")
                self._run("attempts")
                finished, stalled, jac_pending = self._flags()

        st = self.state
        n_att = int(st["n_att"])
        failed = bool(st["failed"]) or (
            n_att >= self.max_attempts and bool(st["t"] < self.t_end)
        )
        ys = st["ys"].clone()
        ys[0] = y0
        info = {
            "success": not failed,
            "nfev": int(st["nfev"]),
            "nlu": int(st["nlu"]),
            "t_final": float(st["t"]),
            "h_abs_final": float(st["h_abs"]),
            "n_attempts": n_att,
        }
        return ys, info


def radau5_integrate(fun, t_span, y0, t_eval, **kwargs):
    """integrate dy/dt = fun(t, y) over t_span, reporting y at t_eval

    The JAX package's `radau5_integrate` signature: one Radau5 built for
    y0's dtype and device and run once.  See Radau5 for fun's contract and
    the keyword arguments (jac_bands and bandwidth select the banded
    mode).
    """
    y0 = torch.as_tensor(y0)
    solver = Radau5(
        fun, y0.reshape(-1).shape[0], t_span, t_eval,
        dtype=y0.dtype, device=y0.device, **kwargs,
    )
    return solver.integrate(y0)

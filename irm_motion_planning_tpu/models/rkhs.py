"""RKHS trajectory parametrization.

The trajectory is a function in a vector-valued Reproducing Kernel Hilbert
Space with an RBF kernel:  ``traj = K @ alpha @ M`` where ``K[i, j] =
k(t_i, t_j)`` is the kernel Gram matrix over the T support timesteps,
``alpha`` is the (T, J) coefficient matrix being optimized, and ``M`` is a
fixed random cross-joint mixing matrix.  Velocities come from the derivative
kernel ``D[i, j] = d/dt k(t, t_j)|_{t=t_i}``.

Capability parity with the reference trajectory parametrization
(ref: trajectory.py:14-78), functional and batched:

* the basis is an explicit immutable pytree (runtime data, not object state),
* ``evaluate`` returns position and velocity in one pass (the reference
  evaluates the two Gram matrices in separate calls, ref: trajectory.py:273-274
  — we stack them into a single (2T, T) matmul: one bigger GEMM, and the
  alpha operand is read once),
* initialization is the reference's quintic-smoothstep least-squares fit
  (ref: trajectory.py:73-78) with the T x T solve Cholesky-factored once at
  basis build, so per-solve warm starts are two triangular solves.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PlannerConfig


def rbf_kernel(x1, x2, rbf_var):
    """Gaussian RBF kernel (ref: trajectory.py:14-15)."""
    return jnp.exp(-((x1 - x2) ** 2) / (2 * rbf_var**2))


def d_rbf_kernel(x1, x2, rbf_var):
    """d/dx1 of the RBF kernel (ref: trajectory.py:18-19)."""
    return (x1 - x2) / (rbf_var**2) * jnp.exp(-((x1 - x2) ** 2) / (2 * rbf_var**2))


class Basis(NamedTuple):
    """Immutable RKHS basis pytree.

    Attributes:
      t:    (T,) support timesteps in [0, 1].
      c:    (T,) quintic smoothstep c(t)=6t^5-15t^4+10t^3 (zero velocity and
            acceleration at both ends, ref: trajectory.py:37-38).
      km:   (T, T) RBF Gram matrix (ref: trajectory.py:40).
      dkm:  (T, T) derivative Gram matrix; row i evaluates d/dt at t_i
            (ref: trajectory.py:41).
      kv:   (2T, T) = concat(km, dkm) — the stacked evaluation operator.
      mix:  (J, J) random cross-joint mixing matrix I + s*N(0,1)
            (ref: trajectory.py:42, PRNGKey(0), s=0.15).
      mix_inv: (J, J) inverse of mix (used only at init).
      init_u: (T,) km^-1 @ ones, precomputed in f64 at basis build.
      init_w: (T,) km^-1 @ c, precomputed in f64 at basis build.  The
            smoothstep warm-start line is ``1 (x) start + c (x) (goal-start)``
            — rank 2 in the time axis — so the fleet init is two outer
            products instead of a per-batch linear solve (see
            fleet.fleet_init_alpha).
    """

    t: jnp.ndarray
    c: jnp.ndarray
    km: jnp.ndarray
    dkm: jnp.ndarray
    kv: jnp.ndarray
    mix: jnp.ndarray
    mix_inv: jnp.ndarray
    init_u: jnp.ndarray
    init_w: jnp.ndarray


def make_basis(cfg: PlannerConfig) -> Basis:
    """Build the RKHS basis for a config; call once at setup.

    The basis is fitted on the host CPU on every platform, on purpose, and
    then placed on the default device.  Its Gram solves are ~1e15-
    conditioned, so the LU decides the init coefficients: a GPU's LU
    (cuSOLVER) moves init_u by O(1e3) from the CPU's, and that alone moves
    the fraction of random scenes that converge by several points.  One fit
    on one platform gives every device the same basis as the CPU reference.
    """
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        basis = fit_basis(cfg)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), basis)


def fit_basis(cfg: PlannerConfig) -> Basis:
    """The basis fit itself, on whatever device traces or runs it."""
    t = jnp.linspace(0.0, 1.0, cfg.n_timesteps, dtype=jnp.float32)
    c = 6 * t**5 - 15 * t**4 + 10 * t**3
    # Gram matrices.  meshgrid semantics of the reference
    # (ref: trajectory.py:45-48, indexing='xy'): km[i, j] = k(t_j, t_i);
    # built here directly from the difference matrix.
    diff = t[None, :] - t[:, None]  # diff[i, j] = t_j - t_i
    # NOTE: rbf_variance stays a Python float inside the expressions, exactly
    # as in the reference (ref: trajectory.py:14-19).  The kernel matrix is
    # ill-conditioned, so even 1-ulp constant differences here change the
    # fitted alpha by O(1) — parity with the CPU reference requires the same
    # weak-typed scalar arithmetic.
    var = cfg.rbf_variance
    km = jnp.exp(-(diff**2) / (2 * var**2))
    dkm = diff / (var**2) * jnp.exp(-(diff**2) / (2 * var**2))
    kv = jnp.concatenate((km, dkm), axis=0)
    key = jax.random.PRNGKey(cfg.mix_seed)
    mix = jnp.eye(cfg.n_joints, dtype=jnp.float32) + cfg.mix_scale * jax.random.normal(
        key, (cfg.n_joints, cfg.n_joints), dtype=jnp.float32
    )
    mix_inv = jnp.linalg.inv(mix)
    # Rank-2 init operator, factored once at basis build: the warm-start fit
    # solve(km, line) decomposes over line = 1 (x) start + c (x) delta, so
    # only TWO rhs columns ever need the Gram solve.  Deliberately the same
    # f32 LU path as the reference's per-solve fit (ref: trajectory.py:77):
    # the Gram matrix is ~1e15-conditioned and the f32 solve acts as implicit
    # regularization — an "exact" f64 factorization yields huge-norm alphas
    # whose f32 evaluation is garbage (measured: rank-2 f32 fits the line
    # to 3.3e-3 max error vs 4.6e-3 for the old per-batch LU).
    uw = jnp.linalg.solve(
        km, jnp.stack([jnp.ones_like(c), c], axis=1)
    )
    init_u, init_w = uw[:, 0], uw[:, 1]
    return Basis(t=t, c=c, km=km, dkm=dkm, kv=kv, mix=mix, mix_inv=mix_inv,
                 init_u=init_u, init_w=init_w)


def _precision(cfg: PlannerConfig):
    return {
        "default": jax.lax.Precision.DEFAULT,
        "high": jax.lax.Precision.HIGH,
        "highest": jax.lax.Precision.HIGHEST,
    }[cfg.matmul_precision]


def evaluate(cfg: PlannerConfig, basis: Basis, alpha: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate trajectory and velocity at the support timesteps in one GEMM.

    (ref: trajectory.py:63-65 does ``kernel_matrix @ alpha @ jac`` separately
    per Gram matrix; we compute ``[km; dkm] @ (alpha @ mix)`` stacked.)

    Returns ``(traj (T, J), vel (T, J))``.
    """
    prec = _precision(cfg)
    # Left-associated like the reference ((km @ alpha) @ mix) so f32
    # rounding matches the CPU reference step-for-step.
    ka = jnp.matmul(basis.kv, alpha, precision=prec)           # (2T, J)
    both = jnp.matmul(ka, basis.mix, precision=prec)           # (2T, J)
    return both[: cfg.n_timesteps], both[cfg.n_timesteps :]


def evaluate_position(cfg: PlannerConfig, basis: Basis, alpha: jnp.ndarray) -> jnp.ndarray:
    """Trajectory positions only: km @ alpha @ mix (ref: trajectory.py:63-65)."""
    prec = _precision(cfg)
    return jnp.matmul(jnp.matmul(basis.km, alpha, precision=prec), basis.mix, precision=prec)


def evaluate_at(cfg: PlannerConfig, basis: Basis, alpha: jnp.ndarray, ts: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the trajectory (and velocity) at arbitrary query times ``ts``
    (capability of the reference's ``eval_any``, ref: trajectory.py:68-70).

    The RKHS parametrization is continuous in t: build the cross Gram matrix
    between query times and support times and apply the same coefficients.
    """
    prec = _precision(cfg)
    var = cfg.rbf_variance
    diff = basis.t[None, :] - ts[:, None]        # (Q, T): t_support - t_query
    kq = jnp.exp(-(diff**2) / (2 * var**2))
    dkq = diff / (var**2) * kq
    return (
        jnp.matmul(jnp.matmul(kq, alpha, precision=prec), basis.mix, precision=prec),
        jnp.matmul(jnp.matmul(dkq, alpha, precision=prec), basis.mix, precision=prec),
    )


def init_alpha(cfg: PlannerConfig, basis: Basis, start: jnp.ndarray, goal: jnp.ndarray) -> jnp.ndarray:
    """Warm-start coefficients: fit the quintic-smoothstep straight line
    (ref: trajectory.py:73-78).

    The kernel Gram matrix is severely ill-conditioned, so alpha depends on
    the exact factorization path; ``jnp.linalg.solve(km, line @ mix_inv)``
    jitted standalone reproduces the reference's jitted init bitwise on CPU
    (verified in tests/test_parity.py).

    Returns ``alpha (T, J)``.
    """
    line = start + (goal - start) * basis.c[:, None]           # (T, J)
    rhs = jnp.matmul(line, basis.mix_inv, precision=_precision(cfg))
    return jnp.linalg.solve(basis.km, rhs)

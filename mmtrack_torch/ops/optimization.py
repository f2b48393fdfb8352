"""Least-squares solvers over pytrees of tensors: conjugate gradient, the
carried-direction Polak-Ribiere CG, Gauss-Newton CG and the Gauss-Newton
steepest descent of the meta-learned heads, port of
mmtrack_tpu/ops/optimization.py.

A pytree here is a tensor, or a tuple, list or dict of pytrees; dict
leaves are visited in sorted key order, as jax.tree does, so a sum over
leaves adds in JAX's order. The Jacobian products come from torch.func:
`vjp` once per Gauss-Newton step, `jvp` of the residuals for each
product J u (the forward recomputed with it; torch.func.linearize traces
a graph per call, which costs more host time than it saves). The loops
are Python loops of a fixed count, and every guard (a zero denominator,
a dead iteration, the beta clamp) is a `torch.where` on the device: no
iteration reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jvp, vjp

from mmtrack_torch.parallel.mesh import SINGLE, Shard


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.vdot: both flattened, the first conjugated."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def _tree_vdot(a, b) -> torch.Tensor:
    return sum(_vdot(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _tree_axpy(alpha, x, y):
    return tree_map(lambda a, b: alpha * a + b, x, y)


def _where(cond, a, b):
    return tree_map(lambda u, v: torch.where(cond, u, v), a, b)


def conjugate_gradient(A: Callable, b, x0, num_iter: int, eps: float = 1e-10, precond=None):
    """Solve A x = b for a symmetric PSD linear operator on pytrees:
    (optionally preconditioned) CG, `precond` M^-1 as a pytree function."""
    M1 = precond or (lambda t: t)
    x = x0
    r = tree_map(lambda bb, ax: bb - ax, b, A(x0))
    p = M1(r)
    rho = _tree_vdot(r, p)
    for _ in range(num_iter):
        Ap = A(p)
        denom = _tree_vdot(p, Ap)
        alpha = torch.where(torch.abs(denom) > eps, rho / denom, 0.0)
        x = _tree_axpy(alpha, p, x)
        r = _tree_axpy(-alpha, Ap, r)
        z = M1(r)
        rho_new = _tree_vdot(r, z)
        beta = torch.where(torch.abs(rho) > eps, rho_new / rho, 0.0)
        p = _tree_axpy(beta, p, z)
        rho = rho_new
    return x


def cg_state_init(x):
    """An empty carried direction for `conjugate_gradient_stateful`:
    (p, rho, r_prev, has_p) with p and r_prev zeros like x, rho one in the
    variable's real dtype, has_p false."""
    zeros = tree_map(torch.zeros_like, x)
    leaf = tree_leaves(x)[0]
    dt = leaf.real.dtype if leaf.is_complex() else leaf.dtype
    return (zeros, torch.ones((), dtype=dt, device=leaf.device), zeros,
            torch.zeros((), dtype=torch.bool, device=leaf.device))


def conjugate_gradient_stateful(A: Callable, b, x0, num_iter: int, state, precond=None,
                                fletcher_reeves: bool = True,
                                direction_forget_factor: float = 0.0, eps: float = 1e-10):
    """CG in the reference's loop order with its direction carried across
    calls: the Polak-Ribiere beta (fletcher_reeves=False) clamped at 0, and
    the direction p with its rho kept in `state`, rho divided by
    direction_forget_factor on entry (0 resets the state). A dead
    iteration (rho == 0) freezes the whole carry, as the reference returns
    there. Returns (x, new state)."""
    M1 = precond or (lambda t: t)
    p, rho, r_prev, has_p = state
    if direction_forget_factor == 0.0:
        p, rho, r_prev, has_p = cg_state_init(x0)
    else:
        rho = torch.where(has_p, rho / direction_forget_factor, rho)

    x = x0
    r = tree_map(lambda bb, ax: bb - ax, b, A(x0))
    for _ in range(num_iter):
        z = M1(r)
        rho1 = rho
        rho_new = torch.real(_tree_vdot(r, z)).to(rho1.dtype)
        alive = torch.abs(rho_new) > eps
        safe_rho1 = torch.where(torch.abs(rho1) > eps, rho1, 1.0)
        if fletcher_reeves:
            beta = rho_new / safe_rho1
        else:
            rr = torch.real(_tree_vdot(r_prev, z)).to(torch.float32)
            beta = (rho_new - rr) / safe_rho1
        beta = torch.clamp(beta, min=0.0)
        beta = torch.where(has_p & alive & (torch.abs(rho1) > eps), beta, 0.0)
        p = _where(alive, _tree_axpy(beta, p, z), p)
        q = A(p)
        pq = torch.real(_tree_vdot(p, q))
        alpha = torch.where(alive & (torch.abs(pq) > eps), rho_new / pq, 0.0)
        if not fletcher_reeves:
            r_prev = _where(alive, r, r_prev)
        x = _tree_axpy(alpha, p, x)
        r = _tree_axpy(-alpha, q, r)
        rho = torch.where(alive, rho_new, rho1)
        has_p = has_p | alive
    return x, (p, rho, r_prev, has_p)


def normal_equations(residual_fn: Callable, x):
    """(A, b) of one Gauss-Newton step at x: A u = J^T J u and b = -J^T r."""
    r, vjp_fn = vjp(residual_fn, x)

    def A(u):
        return vjp_fn(jvp(residual_fn, (x,), (u,))[1])[0]

    return A, tree_map(lambda g: -g, vjp_fn(r)[0])


def gauss_newton_cg(residual_fn: Callable, x, num_gn_iter: int, num_cg_iter: int,
                    precond=None, fletcher_reeves: bool = True):
    """Minimise ||residual_fn(x)||^2 by num_gn_iter Gauss-Newton steps, each
    solved by num_cg_iter CG iterations on the normal equations from zero;
    fletcher_reeves=False takes the Polak-Ribiere beta with a fresh
    direction each step. `precond` preconditions the inner solves."""
    for _ in range(num_gn_iter):
        A, b = normal_equations(residual_fn, x)
        zero = tree_map(torch.zeros_like, x)
        if fletcher_reeves:
            dx = conjugate_gradient(A, b, zero, num_cg_iter, precond=precond)
        else:
            dx, _ = conjugate_gradient_stateful(A, b, zero, num_cg_iter, cg_state_init(zero),
                                                precond=precond, fletcher_reeves=False,
                                                direction_forget_factor=0.0)
        x = tree_map(torch.add, x, dx)
    return x


def steepest_descent_gn(residual_fn: Callable, x, num_iter: int,
                        steplength_reg: float = 0.0, batch_dims: int = 0,
                        shard: Shard = SINGLE):
    """Gauss-Newton steepest descent over pytree parameters: per iteration
    g = J^T r, h = J g, alpha = |g|^2 / (|h|^2 + steplength_reg |g|^2),
    x <- x - alpha g; batch_dims > 0 takes one alpha per sample over the
    leading axes every leaf shares. With batch_dims 0 the parameters are
    shared by the whole batch: under a data-parallel `shard` g and |h|^2
    are summed over the ranks (with their gradients), so each rank takes
    the step of the global batch (a residual term that every rank holds
    once, a regulariser, is the caller's to scale by 1 / sqrt(world))."""
    def sqr_norm(tree):
        if batch_dims == 0:
            return sum(torch.sum(torch.square(leaf)) for leaf in tree_leaves(tree))
        return sum(torch.sum(torch.square(leaf).reshape(leaf.shape[:batch_dims] + (-1,)), dim=-1)
                   for leaf in tree_leaves(tree))

    def scaled_sub(p, g, alpha):
        a = alpha if batch_dims == 0 else alpha.reshape(alpha.shape + (1,) * (g.ndim - batch_dims))
        return p - a * g

    shared = batch_dims == 0 and shard.world > 1
    for _ in range(num_iter):
        r, vjp_fn = vjp(residual_fn, x)
        g = vjp_fn(r)[0]
        if shared:
            g = tree_map(shard.sum, g)
        h = jvp(residual_fn, (x,), (g,))[1]
        ip_gg, ip_hh = sqr_norm(g), sqr_norm(h)
        if shared:
            ip_hh = shard.sum(ip_hh)
        alpha = ip_gg / torch.clamp(ip_hh + steplength_reg * ip_gg, min=1e-8)
        x = tree_map(lambda p, gg: scaled_sub(p, gg, alpha), x, g)
    return x


def mlu(x: torch.Tensor, a: float = 0.05) -> torch.Tensor:
    """The 'mlu' response activation: elu(leaky_relu(x, 1 / a), alpha=a)."""
    y = torch.where(x >= 0, x, x * (1.0 / a))
    return torch.where(y >= 0, y, a * (torch.exp(y) - 1.0))

"""O(1)-memory adjoint gradients of the Euler-Maruyama and Euler
integrators (port of diffpure_tpu/solvers/adjoint.py: ``sdeint_em_adjoint``
:38-98, ``odeint_euler_adjoint`` :102-148).

The forward loop keeps no graph. The backward walks the steps in reverse:
it reconstructs x_i = x_{i+1} - f(x_{i+1}, t_i) dt - g(t_i) dW_i with the
Brownian increment replayed by index (the drift taken at x_{i+1}: the
adjoint-SDE approximation), then takes one vector-Jacobian product of the
drift at x_i and accumulates a += a^T df/dx dt (and a^T df/dtheta dt for the
parameters that require grad). One set of model activations is alive at a
time; the price is the usual O(dt) discretisation error of the adjoint, so
this gradient is close to, not equal to, the checkpointed one.

As in JAX, the diffusion g(t) is taken to be state- and parameter-free
(diagonal noise, DiffPure's case), so it adds no VJP term. The ODE form
drops the noise: x_i = x_{i+1} - f(x_{i+1}, t_i) dt, one VJP at x_i.
Tensors the drift closes over get no gradient unless passed as ``params``
(torchsde's ``adjoint_params``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from diffpure_tpu_torch.solvers.em import em_step, em_time
from diffpure_tpu_torch.utils.profiling import record_nfe

Tensor = torch.Tensor


def _adjoint_sweep(drift, x: Tensor, a: Tensor, params, need, t0: float,
                   dt: float, n_steps: int, rebuild):
    """The backward walk shared by both solvers: ``rebuild(x, tb, i)``
    undoes step i under no_grad, then one VJP of the drift at the rebuilt
    state accumulates a and the parameters' cotangents."""
    wrt = [p for p, n in zip(params, need) if n]
    gp = [torch.zeros_like(p) for p in wrt]
    for i in reversed(range(n_steps)):
        tb = torch.full((x.shape[0],), em_time(t0, dt, i), dtype=x.dtype, device=x.device)
        with torch.no_grad():
            x_prev = rebuild(x, tb, i)
        with torch.enable_grad():
            xp = x_prev.detach().requires_grad_(True)
            grads = torch.autograd.grad(drift(xp, tb), [xp, *wrt], a)
        a = a + grads[0] * dt
        gp = [acc + d * dt for acc, d in zip(gp, grads[1:])]
        x = x_prev
    it = iter(gp)
    return (None, a, *[next(it) if n else None for n in need])


class _EMAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x0, *params):
        drift, diffusion, t0, t1, n_steps, dw = spec
        dt = (t1 - t0) / n_steps
        x = x0
        for i in range(n_steps):
            x = em_step(drift, diffusion, x, em_time(t0, dt, i), dt, dw(i))
        ctx.spec = spec
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, g_out):
        drift, diffusion, t0, t1, n_steps, dw = ctx.spec
        x, *params = ctx.saved_tensors

        def rebuild(x, tb, i):
            g = diffusion(tb)
            g = g.reshape(g.shape + (1,) * (x.ndim - g.ndim))
            return x - drift(x, tb) * dt - g * dw(i)

        dt = (t1 - t0) / n_steps
        return _adjoint_sweep(drift, x, g_out, params, ctx.needs_input_grad[2:], t0, dt,
                              n_steps, rebuild)


def sdeint_em_adjoint(drift: Callable[[Tensor, Tensor], Tensor],
                      diffusion: Callable[[Tensor], Tensor], x0: Tensor,
                      t0: float, t1: float, n_steps: int,
                      dw: Callable[[int], Tensor],
                      params: Sequence[Tensor] = ()) -> Tensor:
    """Euler-Maruyama solve (as ``sdeint_em``) differentiable with respect
    to x0 and ``params`` (tensors the drift closes over) by the adjoint.
    ``dw(i)`` must return the same increment every time it is called.
    Records ``n_steps`` evaluations as ``"sde_euler_adjoint"`` (JAX
    adjoint.py:55); the backward's drift evaluations do not count."""
    record_nfe("sde_euler_adjoint", n_steps)
    return _EMAdjoint.apply((drift, diffusion, t0, t1, n_steps, dw), x0,
                            *params)


class _EulerAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x0, *params):
        func, t0, t1, n_steps = spec
        dt = (t1 - t0) / n_steps
        x = x0
        for i in range(n_steps):
            tb = torch.full((x.shape[0],), em_time(t0, dt, i), dtype=x.dtype, device=x.device)
            x = x + func(x, tb) * dt
        ctx.spec = spec
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, g_out):
        func, t0, t1, n_steps = ctx.spec
        x, *params = ctx.saved_tensors
        dt = (t1 - t0) / n_steps
        return _adjoint_sweep(func, x, g_out, params, ctx.needs_input_grad[2:], t0, dt,
                              n_steps, lambda x, tb, i: x - func(x, tb) * dt)


def odeint_euler_adjoint(func: Callable[[Tensor, Tensor], Tensor], x0: Tensor,
                         t0: float, t1: float, n_steps: int,
                         params: Sequence[Tensor] = ()) -> Tensor:
    """Euler ODE solve (as ``odeint_euler``) differentiable with respect to
    x0 and ``params`` by the adjoint: the backward rebuilds
    x_i = x_{i+1} - f(x_{i+1}, t_i) dt and takes one VJP at x_i, so the
    drift runs twice a step there (once without a graph). Records
    ``n_steps`` evaluations as ``"ode_euler_adjoint"`` (JAX adjoint.py:124)."""
    record_nfe("ode_euler_adjoint", n_steps)
    return _EulerAdjoint.apply((func, t0, t1, n_steps), x0, *params)

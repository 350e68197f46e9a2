"""ISTA for sparse NMF inference -- the algorithm the DR-NMF network unfolds.

jnp reimplementation of the reference's numpy oracles (enhance.py:385-456):
``ista_ed`` / ``ista_kl`` / ``ista_beta`` run K iterations of nonnegative
soft-thresholded gradient steps on ``min_H  D_beta(x, W H) + lam1 |H|_1``.
These serve three roles here, as there: (1) mathematical ground truth for the
unfolded DR-NMF cell at initialization (tests assert the equivalence), and
(2) a usable standalone inference engine.

All functions are pure, jit-able, and operate on column-major frame matrices
``x: (m, n)``, ``H: (r, n)``, dictionary ``W: (m, r)``.
"""

from functools import partial

import jax
import jax.numpy as jnp


def kl_div(x, y):
    """Generalized KL divergence, elementwise (enhance.py:385-388 semantics)."""
    log_x = jnp.log(1e-9 + x)
    log_y = jnp.log(1e-9 + y)
    return x * log_x - x * log_y - x + y


def beta_div(x, y, beta):
    """Beta divergence, elementwise (enhance.py:391-400 semantics)."""
    if beta == 1.0:
        return kl_div(x, y)
    if beta == 0.0:
        return (x / y) - jnp.log(1e-9 + x) + jnp.log(1e-9 + y) - 1.0
    return (1.0 / (beta * (beta - 1.0))) * (
        x**beta + (beta - 1.0) * y**beta - beta * x * y ** (beta - 1.0)
    )


def _soft(x):
    return jnp.maximum(0.0, x)


@partial(jax.jit, static_argnames=("n_steps",))
def ista_ed(x, w, h, lam1, alph, n_steps: int):
    """K steps of ISTA under Euclidean distance (enhance.py:402-418):
    ``H <- max(0, -lam1/alph + H + (1/alph) W^T (x - W H))``."""

    def step(h, _):
        xest = jnp.dot(w, h, preferred_element_type=jnp.float32)
        h = _soft(
            -lam1 / alph
            + h
            + (1.0 / alph) * jnp.dot(w.T, x - xest, preferred_element_type=jnp.float32)
        )
        return h, None

    h, _ = jax.lax.scan(step, h, None, length=n_steps)
    return h


@partial(jax.jit, static_argnames=("n_steps",))
def ista_kl(x, w, h, lam1, alph, n_steps: int):
    """K steps of ISTA under KL divergence (enhance.py:421-437):
    ``H <- max(0, -lam1/alph + H + (1/alph) W^T (x / (W H) - 1))``."""

    def step(h, _):
        xest = jnp.dot(w, h, preferred_element_type=jnp.float32)
        h = _soft(
            -lam1 / alph
            + h
            + (1.0 / alph)
            * jnp.dot(w.T, x / xest - 1.0, preferred_element_type=jnp.float32)
        )
        return h, None

    h, _ = jax.lax.scan(step, h, None, length=n_steps)
    return h


@partial(jax.jit, static_argnames=("n_steps", "beta"))
def ista_beta(x, w, h, lam1, alph, n_steps: int, beta: float):
    """K steps of ISTA under beta divergence (enhance.py:440-456)."""

    def step(h, _):
        xest = jnp.dot(w, h, preferred_element_type=jnp.float32)
        grad_term = x * xest ** (beta - 2.0) - xest ** (beta - 1.0)
        h = _soft(
            -lam1 / alph
            + h
            + (1.0 / alph) * jnp.dot(w.T, grad_term, preferred_element_type=jnp.float32)
        )
        return h, None

    h, _ = jax.lax.scan(step, h, None, length=n_steps)
    return h


def ista(x, w, h, lam1, alph, n_steps: int, beta: float = 2.0):
    """Dispatch on beta: 2 -> ED, 1 -> KL, else generic beta."""
    if beta == 2.0:
        return ista_ed(x, w, h, lam1, alph, n_steps)
    if beta == 1.0:
        return ista_kl(x, w, h, lam1, alph, n_steps)
    return ista_beta(x, w, h, lam1, alph, n_steps, beta)

"""LSTM mask-prediction baseline with matched parameter counts.

Reimplements the reference's Keras baseline (enhance.py:321-345): Masking ->
K stacked LSTM(hidden_dim, return_sequences) -> TimeDistributed Dense ->
sigmoid == the predicted ratio mask.

Cell semantics follow Keras 2.0.4 defaults the reference relied on:
``tanh`` activation, ``hard_sigmoid`` recurrent activation
(max(0, min(1, 0.2x + 0.5))), unit forget-gate bias, glorot-uniform kernels,
orthogonal recurrent kernels.  The time recurrence is a single ``lax.scan``
per layer; layers are stacked functionally.
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class LSTMConfig:
    input_dim: int = 257
    hidden_dim: int = 250
    output_dim: int = 257
    K_layers: int = 2
    mask_value: float = -1.0
    # lax.scan unroll for the recurrence: pure scheduling, identical math
    # (same lever as DRNMFConfig.scan_unroll -- the measured win is
    # backward-pass loop-overhead amortization, DESIGN §3b)
    scan_unroll: int = 4


def _glorot(key, shape):
    fan_in, fan_out = shape[0], shape[1]
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, jnp.float32, -limit, limit)


def _orthogonal(key, n):
    a = jax.random.normal(key, (n, n), jnp.float32)
    q, r = jnp.linalg.qr(a)
    return q * jnp.sign(jnp.diag(r))[None, :]


def init_lstm_params(config: LSTMConfig, key=None) -> dict:
    if key is None:
        key = jax.random.PRNGKey(7654)
    params = {}
    dim_in = config.input_dim
    n = config.hidden_dim
    for layer in range(config.K_layers):
        key, k1, k2 = jax.random.split(key, 3)
        # gate order i, f, c, o packed on the last axis (Keras convention)
        params[f"lstm{layer}_Wx"] = _glorot(k1, (dim_in, 4 * n))
        params[f"lstm{layer}_Wh"] = jnp.concatenate(
            [_orthogonal(jax.random.fold_in(k2, g), n) for g in range(4)], axis=1
        )
        bias = np.zeros((4 * n,), np.float32)
        bias[n : 2 * n] = 1.0  # unit forget-gate bias
        params[f"lstm{layer}_b"] = jnp.asarray(bias)
        dim_in = n
    key, kd = jax.random.split(key)
    params["dense_W"] = _glorot(kd, (n, config.output_dim))
    params["dense_b"] = jnp.zeros((config.output_dim,), jnp.float32)
    return params


def _hard_sigmoid(x):
    return jnp.clip(0.2 * x + 0.5, 0.0, 1.0)


def _lstm_layer(wx, wh, b, x, step_mask, unroll=1):
    """x: (B, T, D) -> (B, T, N).  Masked steps hold (h, c)."""
    n = wh.shape[0]
    bsz = x.shape[0]
    xT = jnp.swapaxes(x, 0, 1)
    mT = jnp.swapaxes(step_mask, 0, 1)
    # hoist the input projection out of the scan: one big matmul
    zx = jnp.dot(xT, wx, preferred_element_type=jnp.float32) + b  # (T, B, 4N)

    def step(carry, inp):
        h, c = carry
        zx_t, m_t = inp
        z = zx_t + jnp.dot(h, wh, preferred_element_type=jnp.float32)
        i = _hard_sigmoid(z[:, :n])
        f = _hard_sigmoid(z[:, n : 2 * n])
        g = jnp.tanh(z[:, 2 * n : 3 * n])
        o = _hard_sigmoid(z[:, 3 * n :])
        c_new = f * c + i * g
        h_new = o * jnp.tanh(c_new)
        m = m_t[:, None]
        h_new = jnp.where(m, h_new, h)
        c_new = jnp.where(m, c_new, c)
        return (h_new, c_new), h_new

    init = (
        jnp.zeros((bsz, n), jnp.float32),
        jnp.zeros((bsz, n), jnp.float32),
    )
    _, hs = jax.lax.scan(step, init, (zx, mT), unroll=max(1, unroll))
    return jnp.swapaxes(hs, 0, 1)


@partial(jax.jit, static_argnames=("config",))
def lstm_apply(params: dict, config: LSTMConfig, x: jnp.ndarray) -> jnp.ndarray:
    """(B, T, F) noisy magnitudes -> (B, T, F) sigmoid mask."""
    step_mask = jnp.any(x != config.mask_value, axis=-1)
    h = x
    for layer in range(config.K_layers):
        h = _lstm_layer(
            params[f"lstm{layer}_Wx"],
            params[f"lstm{layer}_Wh"],
            params[f"lstm{layer}_b"],
            h,
            step_mask,
            unroll=config.scan_unroll,
        )
    logits = (
        jnp.dot(h, params["dense_W"], preferred_element_type=jnp.float32)
        + params["dense_b"]
    )
    return jax.nn.sigmoid(logits)

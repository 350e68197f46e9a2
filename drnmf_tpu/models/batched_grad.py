"""Batched-T backward for the plain DR-NMF recurrence (custom VJP).

XLA's transpose of ``lax.scan`` accumulates every parameter gradient
INSIDE the backward scan: per timestep it issues (2r, B) x (B, 2r)-shaped
matmuls whose contraction dim is the batch (32 at the reference schedule,
enhance.py:1152) -- thin products that fill little of a matrix unit.  The
time RECURRENCE is genuinely sequential, but the parameter gradients are
not: given the per-step pre-activation gradients ``delta_{k,t}``, every
weight gradient is one big matmul contracting over T*B (=16,000 at the
parity schedule).

This module implements that split for the production configuration
(relu, connect_input_to_layers, frozen-U fold + factored S -- every
shipped reference config):

* forward: the SAME step math as models/drnmf.py::_scan_hidden (bitwise
  identical outputs), additionally stashing each layer's hidden states;
* backward: a reverse scan computing ONLY the sequential delta chain
  (same per-step matmul count as the forward), then all of
  d(log_D)/d(alph)-facing factor grads, dW0, db, dx as T*B-contraction
  matmuls outside the scan.

Memory: residuals are the (T, K, B, 2r) hidden stack (~640 MB at the
flagship parity schedule) plus the same-shaped delta stack transiently in
the backward; the router in drnmf.py falls back to autodiff-through-scan
(with remat) when the stack would exceed its budget.

Reference recurrence being differentiated: custom_layers.py:343-375 (the
K-layer ISTA stack), parameter maps enhance.py:162-204.
"""

from functools import partial

import jax
import jax.numpy as jnp


def _rowsum(v):
    return jnp.sum(v, axis=-1, keepdims=True)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def scan_plain_batched(static, fu, dks, dkas, w0, bs, h_init, xT, mT):
    """Forward-identical plain scan with a batched-T backward.

    static: (K, unroll, precision) hashable; fu: (diag1, off1, c) FoldedU
    fields; dks/dkas: per-layer factored-S lists (K-1 each); w0: layer-0
    input weights; bs: per-layer biases (K); h_init: (B, 2r); xT: (T, B,
    F); mT: (T, B) bool.  Returns hs (T, B, 2r)."""
    hs, _ = _fwd_core(static, fu, dks, dkas, w0, bs, h_init, xT, mT)
    return hs


def _fwd_core(static, fu, dks, dkas, w0, bs, h_init, xT, mT):
    K, unroll, prec = static
    diag1, off1, c = fu
    dot = partial(jnp.dot, precision=prec,
                  preferred_element_type=jnp.float32)

    def step(carry, inp):
        x_t, m_t = inp
        rs = _rowsum(carry)
        hiddens = []
        hidden = None
        for k in range(K):
            if k == 0:
                pre = carry * (diag1 - off1) + off1 * rs + dot(x_t, w0)
            else:
                dk, dka = dks[k - 1], dkas[k - 1]
                pre = (c * rs + hidden
                       + dot(x_t - dot(hidden, dk.T), dka))
            hidden = jax.nn.relu(pre + bs[k])
            hiddens.append(hidden)
        new_carry = jnp.where(m_t[:, None], hidden, carry)
        return new_carry, (new_carry, jnp.stack(hiddens, axis=0))

    _, (hs, h_all) = jax.lax.scan(step, h_init, (xT, mT),
                                  unroll=max(1, unroll))
    return hs, h_all


def _fwd(static, fu, dks, dkas, w0, bs, h_init, xT, mT):
    hs, h_all = _fwd_core(static, fu, dks, dkas, w0, bs, h_init, xT, mT)
    res = (fu, dks, dkas, w0, bs, h_init, xT, mT, hs, h_all)
    return hs, res


def _bwd(static, res, g):
    K, unroll, prec = static
    fu, dks, dkas, w0, bs, h_init, xT, mT, hs, h_all = res
    diag1, off1, c = fu
    dot = partial(jnp.dot, precision=prec,
                  preferred_element_type=jnp.float32)
    T, B, n2r = hs.shape

    # ---- sequential delta chain (reverse scan; per-step matmul count ==
    # the forward's -- the irreducible recurrence) ---------------------------
    def back_step(gamma, inp):
        g_t, m_t, h_t = inp  # h_t: (K, B, 2r) this step's layer hiddens
        go = g_t + gamma
        g_h = go * m_t[:, None]
        gamma_new = go * (1.0 - m_t[:, None])
        deltas = [None] * K
        for k in range(K - 1, 0, -1):
            d_k = g_h * (h_t[k] > 0)
            deltas[k] = d_k
            dk, dka = dks[k - 1], dkas[k - 1]
            # pre_k = c*rowsum(h_prev) + hidden + (x - hidden@dk^T)@dka
            g_h = d_k - dot(dot(d_k, dka.T), dk)
            gamma_new = gamma_new + c * _rowsum(d_k)
        d_0 = g_h * (h_t[0] > 0)
        deltas[0] = d_0
        gamma_new = gamma_new + d_0 * (diag1 - off1) + off1 * _rowsum(d_0)
        return gamma_new, jnp.stack(deltas, axis=0)

    gamma0 = jnp.zeros_like(h_init)
    gamma, deltas = jax.lax.scan(
        back_step, gamma0, (g, mT, h_all), reverse=True,
        unroll=max(1, unroll))

    # ---- batched parameter gradients: ONE T*B-contraction matmul each ------
    F = xT.shape[-1]
    xf = xT.reshape(T * B, F)
    # h_prev trace per step: h_init at t=0, hs[t-1] after
    hprev = jnp.concatenate([h_init[None], hs[:-1]], axis=0)
    hprev_f = hprev.reshape(T * B, n2r)

    d0f = deltas[:, 0].reshape(T * B, n2r)
    d_w0 = dot(xf.T, d0f)
    d_x = dot(d0f, w0.T)

    d_dks, d_dkas, d_bs = [], [], []
    d_bs.append(jnp.sum(d0f, axis=0))
    for k in range(1, K):
        dk, dka = dks[k - 1], dkas[k - 1]
        dkf = deltas[:, k].reshape(T * B, n2r)
        hkm1 = h_all[:, k - 1].reshape(T * B, n2r)
        r_k = xf - dot(hkm1, dk.T)          # (TB, F)
        p_k = dot(dkf, dka.T)               # (TB, F), shared with d_x
        d_dkas.append(dot(r_k.T, dkf))      # (F, 2r)
        d_dks.append(-dot(p_k.T, hkm1))     # (F, 2r)
        d_bs.append(jnp.sum(dkf, axis=0))
        d_x = d_x + p_k

    # FoldedU fields enter linearly; real grads are cheap elementwise sums
    # (the production fold stop_gradients them to exact zero upstream)
    d0 = deltas[:, 0]
    d_diag1 = jnp.sum(d0 * hprev, axis=(0, 1))
    d_off1 = jnp.sum(d0 * (_rowsum(hprev) - hprev))
    d_c = (jnp.sum(deltas[:, 1:] * _rowsum(hprev)[:, None])
           if K > 1 else jnp.zeros_like(c))

    d_xT = d_x.reshape(T, B, F)
    return ((d_diag1, d_off1, d_c), d_dks, d_dkas, d_w0, d_bs,
            gamma, d_xT, None)


scan_plain_batched.defvjp(_fwd, _bwd)


def batched_grad_residual_bytes(bsz, t, hidden_dim, k_layers):
    """The (T, K, B, 2r) hidden + delta stacks the batched backward holds
    (f32) -- the router's budget check."""
    return 2 * 4 * bsz * t * hidden_dim * k_layers

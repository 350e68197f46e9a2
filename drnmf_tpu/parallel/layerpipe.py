"""Layer-pipelined DR-NMF recurrence: the K unfolds sharded over a 'pp' axis.

Completes the parallelism matrix (dp / tp / sp / 2-D dp x tp / FSDP /
**pp**) for the one axis the others leave alone: the K unfolded ISTA
layers themselves (SimpleDeepRNN stacking, custom_layers.py:104-412 --
the reference ran all layers on one GPU).  Device p OWNS layer p: the
stacked per-layer factors enter the pipeline body sharded over 'pp'
(``in_specs`` P('pp') on the layer axis), so each device holds exactly
its own layer's (F, 2r) dictionary factors and bias -- the only
parallel axis that divides the weight working set by depth K rather
than by hidden width or batch -- and COMPUTES only that layer;
activations hand forward between devices with ``ppermute``.

The cross-time feedback (layer K-1's masked-held state at t-1 feeds every
layer's U term at t, enhance.py:162-204) makes this a RING pipeline: a
single sequence would serialize around it, so the batch is split into
G = P groups interleaved as a wavefront -- with G equal to the ring
length, layer K-1's state for (g, t-1) travels the ring and arrives at
each stage EXACTLY when that stage processes (g, t), no buffering.
Device p at wave s runs group g = (s-p) % G at time t = (s-p) // G
through its layer: T*G + P - 1 waves, per-device compute 1/P of the
single-device scan.  Exact: the schedule only reorders where layer
applications run, not the math (parity with ``_scan_hidden`` is pinned
bitwise-level by test).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models.drnmf import (FoldedU, _ACTIVATIONS, _effective_matrices,
                            _precision)
from ._cache import CompiledCache

# (config, axis, shapes, device ids) -> jitted shard_map
_COMPILED = CompiledCache()


def drnmf_scan_layer_pipelined(params, config, x, step_mask, mesh,
                               axis_name="pp"):
    """Hidden states of the DR-NMF recurrence with the LAYER axis sharded.

    Requires ``config.K_layers == P`` (one layer per 'pp'-axis device) and
    ``B`` divisible by P (the G = P wavefront groups).  Supports the plain
    cell (relu-family activation, connect_input_to_layers, no
    return_all_hidden, no dropout), folded or dense U, factored or dense S.
    Returns (B, T, 2r) hidden states identical to the single-device scan.
    """
    n_pp = int(mesh.shape[axis_name])
    K = config.K_layers
    if K != n_pp:
        raise ValueError(f"K_layers={K} must equal the pp axis size {n_pp}")
    if K < 2:
        # degenerate pipeline (and the K=1 model has no S matrices for the
        # dense-S trace path to reference) -- use the plain scan instead
        raise ValueError(
            "layer pipelining requires K_layers >= 2; use _scan_hidden")
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError(
            "layer-pipelined scan supports the plain cell only")
    if not config.connect_input_to_layers:
        raise NotImplementedError(
            "layer-pipelined scan requires connect_input_to_layers")
    bsz, t_total, f_dim = x.shape
    if bsz % n_pp:
        raise ValueError(f"B={bsz} not divisible by pp={n_pp}")
    n_groups = n_pp  # G = P: ring latency exactly hidden, no buffering
    gsz = bsz // n_groups
    h_dim = config.hidden_dim
    act = _ACTIVATIONS[config.activation]
    prec = _precision(config)

    def stacks(params):
        """Per-layer weight stacks (leading axis = layer, sharded over
        'pp') + replicated small state.  Layer 0 has no S: its slot in
        the S stacks is zeros, never selected (device 0 takes the kk==0
        branch)."""
        U, S, W, b = _effective_matrices(params, config,
                                         fold_u=True, factor_s=True)
        if config.nonnegative:
            h0 = jax.nn.softplus(params["log_h0"])
        else:
            h0 = params["h0"]
        wts = {"w": jnp.stack(W), "b": jnp.stack(b), "h0": h0}
        if bool(S) and isinstance(S[0], tuple):  # factored
            z = jnp.zeros_like(S[0][0])
            wts["dk"] = jnp.stack([z] + [s[0] for s in S])
            wts["dka"] = jnp.stack([z] + [s[1] for s in S])
        elif S:
            z = jnp.zeros_like(S[0])
            wts["s"] = jnp.stack([z] + list(S))
        if isinstance(U, FoldedU):
            wts["u_diag1"], wts["u_off1"], wts["u_c"] = (
                U.diag1, U.off1, U.c)
        else:
            # device p needs only U[min(p, 1)]: stack per layer and shard
            # (16 MB per device at 2r=2000 instead of 2x16 MB replicated)
            wts["u"] = jnp.stack([U[min(k, 1)] for k in range(K)])
        return wts

    def local(wts, x_full, m_full):
        p = jax.lax.axis_index(axis_name)
        dot = partial(jnp.dot, precision=prec,
                      preferred_element_type=jnp.float32)
        # this device's layer: every stacked entry arrives as (1, ...)
        w_p = wts["w"][0]   # (F, 2r)
        b_p = wts["b"][0]   # (2r,)
        h0 = wts["h0"]

        def layer_apply(kk, h_prev, hidden, x_t):
            """This device's layer: pre-activation + activation for its
            wave tuple.  ``h_prev``: layer K-1's held state at t-1 (U term
            source); ``hidden``: layer kk-1's output at t (garbage when
            kk == 0 -- the where() discards that branch)."""
            if folded:
                rs = jnp.sum(h_prev, axis=-1, keepdims=True)
                t1 = h_prev * (wts["u_diag1"] - wts["u_off1"]) \
                    + wts["u_off1"] * rs
                u_k = jnp.where(kk == 0, t1,
                                jnp.broadcast_to(wts["u_c"] * rs, t1.shape))
            else:
                u_k = dot(h_prev, wts["u"][0])
            pre0 = u_k + dot(x_t, w_p)
            if factored:
                dk, dka = wts["dk"][0], wts["dka"][0]
                prek = u_k + hidden + dot(x_t - dot(hidden, dk.T), dka)
            else:
                prek = u_k + dot(hidden, wts["s"][0]) + dot(x_t, w_p)
            return act(jnp.where(kk == 0, pre0, prek) + b_p)

        n_waves = t_total * n_groups + n_pp - 1
        ring = [(i, (i + 1) % n_pp) for i in range(n_pp)]
        def vary(v):
            return jax.lax.pcast(v, axis_name, to="varying")
        out0 = vary(jnp.zeros((bsz, t_total, h_dim), jnp.float32))
        bh0 = vary(jnp.zeros((gsz, h_dim), jnp.float32))  # boundary hidden
        hp0 = vary(jnp.zeros((gsz, h_dim), jnp.float32))  # h_prev in flight
        h0_b = jnp.broadcast_to(h0[None, :], (gsz, h_dim))
        last = p == n_pp - 1

        def wave(s, state):
            out, bh, hp = state
            bh_r = jax.lax.ppermute(bh, axis_name, ring)
            hp_r = jax.lax.ppermute(hp, axis_name, ring)
            idx = s - p
            valid = (idx >= 0) & (idx < t_total * n_groups)
            ic = jnp.clip(idx, 0, t_total * n_groups - 1)
            g, t = ic % n_groups, ic // n_groups
            x_t = jax.lax.dynamic_slice(
                x_full, (g * gsz, t, 0), (gsz, 1, f_dim))[:, 0, :]
            m_t = jax.lax.dynamic_slice(m_full, (g * gsz, t), (gsz, 1))[:, 0]
            h_prev = jnp.where(t == 0, h0_b, hp_r)
            h_out = layer_apply(p, h_prev, bh_r, x_t)
            h_held = jnp.where(m_t[:, None], h_out, h_prev)
            upd = jax.lax.dynamic_update_slice(
                out, h_held[:, None, :], (g * gsz, t, 0))
            out = jnp.where(valid & last, upd, out)
            bh = jnp.where(valid, h_out, bh_r)
            # device K-1 injects the next time step's feedback; others
            # forward what they received (bubbles pass through unchanged)
            hp = jnp.where(valid & last, h_held, hp_r)
            return out, bh, hp

        out, _, _ = jax.lax.fori_loop(0, n_waves, wave, (out0, bh0, hp0))
        # outputs live on device K-1 only; everyone else contributes zeros
        return jax.lax.psum(out, axis_name)

    cache_key = (config, axis_name, tuple(x.shape),
                 tuple(d.id for d in mesh.devices.flat))
    fn = _COMPILED.get(cache_key)
    if fn is None:
        # learn the (config/params-structure-determined) stack layout
        # WITHOUT materializing the stacks: eval_shape traces abstractly
        shapes = jax.eval_shape(stacks, params)
        folded = "u_diag1" in shapes
        factored = "dk" in shapes
        replicated = ("h0", "u_diag1", "u_off1", "u_c")
        specs = {k: (P() if k in replicated else P(axis_name))
                 for k in shapes}

        def run(params, x_full, m_full):
            shard = jax.shard_map(
                local, mesh=mesh,
                in_specs=(specs, P(), P()),  # per-layer weights over 'pp'
                out_specs=P(),
            )
            return shard(stacks(params), x_full, m_full)

        fn = jax.jit(run)
        _COMPILED.put(cache_key, fn)
    return fn(params, jnp.asarray(x), jnp.asarray(step_mask))

"""Sequence-parallel DR-NMF recurrence: pipelined time-sharding over a mesh.

SURVEY.md section 2 (parallelism table): the reference handled long sequences
by *chunking* into maxlen windows, losing recurrent state at chunk
boundaries (reshape_and_pad_stacks, audio_dataset.py:127-168).  The DR-NMF
recurrence is O(1)-state (one (2r,) vector per sequence), so exact sequence
parallelism is a pipeline: shard the time axis into P contiguous chunks
(one per device along the 'sp' mesh axis) and hand the carried state of
chunk p to chunk p+1 between devices with ``ppermute``.

A single sequence gives no overlap (the recurrence is truly sequential), so
the batch is split into G groups and processed as a classic wavefront
pipeline: at wave s, device p runs group ``g = s - p`` through its time
chunk while device p+1 runs group ``g-1`` -- G + P - 1 waves total, device
utilization G / (G + P - 1) -> 1 for G >> P.  This turns time-sharding into
near-linear speedup for long-T batches whose (B, T, F) tensors would not fit
one chip's HBM.

Everything runs inside one ``shard_map``-ed jit program: the wave loop is a
``lax.fori_loop``, the carry handoff is a ``lax.ppermute`` between devices, and
invalid (bubble) waves are masked with ``jnp.where`` -- no host round trips.
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.drnmf import _effective_matrices, make_cell_step
from ._cache import CompiledCache

# (config, axis, n_groups, shapes, device ids) -> jitted shard_map
_COMPILED = CompiledCache()


def _masked_step_factory(config, U, S, W, b):
    """Masked timestep over the shared cell (honors activation /
    connect_input_to_layers / matmul_precision like the single-device
    scan)."""
    cell = make_cell_step(config, U, S, W, b)

    def step(h_prev, inp):
        x_t, m_t = inp
        hidden = cell(h_prev, x_t)
        h_new = jnp.where(m_t[:, None], hidden, h_prev)
        return h_new, h_new

    return step


def drnmf_scan_seq_pipelined(params, config, x, step_mask, mesh,
                             n_groups=None, axis_name="sp"):
    """Hidden states of the DR-NMF recurrence with the TIME axis sharded.

    ``x``: (B, T, F) with T divisible by the 'sp' mesh axis size P and B
    divisible by ``n_groups`` (default P).  Returns (B, T, 2r) hidden states,
    numerically identical to the single-device ``lax.scan`` (the pipeline
    only reorders *where* chunks run, not the math).
    """
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError(
            "sequence-pipelined scan supports the inference cell only "
            "(no return_all_hidden, no dropout); use the single-device scan"
        )
    n_sp = mesh.shape[axis_name]
    bsz, t_total, f_dim = x.shape
    if t_total % n_sp:
        raise ValueError(f"T={t_total} not divisible by sp={n_sp}")
    n_groups = n_groups or n_sp
    if bsz % n_groups:
        raise ValueError(f"B={bsz} not divisible by n_groups={n_groups}")
    gsz = bsz // n_groups
    h_dim = config.hidden_dim

    def local(params_loc, x_loc, m_loc):
        # params enter as (replicated) arguments -- not closure constants --
        # so the jitted program below is reusable across param values
        U, S, W, b = _effective_matrices(params_loc, config, fold_u=True, factor_s=True)
        if config.nonnegative:
            h0 = jax.nn.softplus(params_loc["log_h0"])
        else:
            h0 = params_loc["h0"]
        step = _masked_step_factory(config, U, S, W, b)

        # x_loc: (B, T/P, F) -- this device's time chunk, all groups
        p = jax.lax.axis_index(axis_name)
        t_loc = x_loc.shape[1]
        n_waves = n_groups + n_sp - 1

        def chunk_scan(h_start, xg, mg):
            xT = jnp.swapaxes(xg, 0, 1)  # (t_loc, gsz, F)
            mT = jnp.swapaxes(mg, 0, 1)
            h_fin, hs = jax.lax.scan(step, h_start, (xT, mT))
            return h_fin, jnp.swapaxes(hs, 0, 1)  # (gsz, t_loc, H)

        # pvary: the loop carries are device-varying (they depend on
        # axis_index / ppermute), so mark the zero inits accordingly
        out0 = jax.lax.pcast(jnp.zeros((bsz, t_loc, h_dim), jnp.float32),
                             axis_name, to="varying")
        carry0 = jax.lax.pcast(jnp.zeros((gsz, h_dim), jnp.float32),
                               axis_name, to="varying")

        def wave(s, state):
            out, carry_out = state
            # receive chunk-start state for group g = s - p from device p-1
            recv = jax.lax.ppermute(
                carry_out, axis_name,
                [(i, (i + 1) % n_sp) for i in range(n_sp)],
            )
            g = s - p
            valid = (g >= 0) & (g < n_groups)
            g_idx = jnp.clip(g, 0, n_groups - 1)
            h_start = jnp.where(p == 0,
                                jnp.broadcast_to(h0[None, :], (gsz, h_dim)),
                                recv)
            xg = jax.lax.dynamic_slice_in_dim(x_loc, g_idx * gsz, gsz, axis=0)
            mg = jax.lax.dynamic_slice_in_dim(m_loc, g_idx * gsz, gsz, axis=0)
            h_fin, hs = chunk_scan(h_start, xg, mg)
            out = jnp.where(
                valid,
                jax.lax.dynamic_update_slice_in_dim(out, hs, g_idx * gsz, axis=0),
                out,
            )
            carry_out = jnp.where(valid, h_fin, carry_out)
            return out, carry_out

        out, _ = jax.lax.fori_loop(0, n_waves, wave, (out0, carry0))
        return out

    cache_key = (config, axis_name, n_groups, tuple(x.shape),
                 tuple(d.id for d in mesh.devices.flat))
    fn = _COMPILED.get(cache_key)
    if fn is None:
        shard = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(None, axis_name, None), P(None, axis_name)),
            out_specs=P(None, axis_name, None),
        )
        fn = jax.jit(shard)
        _COMPILED.put(cache_key, fn)
    x_sh = jax.device_put(x, NamedSharding(mesh, P(None, axis_name, None)))
    m_sh = jax.device_put(step_mask, NamedSharding(mesh, P(None, axis_name)))
    return fn(params, x_sh, m_sh)

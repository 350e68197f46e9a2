"""Device-mesh parallelism.

The reference is strictly single-GPU (SURVEY.md section 2: no DP/TP/PP, the
only parallelism is NMF frame chunking and a MATLAB parfor scoring pool).
The scale-out story:

* **Data parallel training**: shard the (B, T, F) batch over a 'dp' mesh
  axis; parameters replicate; XLA inserts the gradient ``psum`` (NCCL
  all-reduce across GPUs).
* **Sharded sparse NMF**: frames (columns of ``v``) shard over 'dp'.  The H
  update is embarrassingly frame-parallel; the W update needs global
  ``v h^T``-style (m, r) statistics, which are *additive over frames* --
  each shard computes its local statistics and a ``psum`` over the axis
  produces identical dictionaries everywhere (the mesh equivalent of the
  reference's warm-started sequential chunk loop, snmf.py:30-75, but exact
  instead of approximate: all frames participate in every update).
* Objective values are psum-reduced the same way, so convergence checks are
  global.  Frames added to round up to the device count are excluded
  exactly via a frame-validity mask (their H columns are pinned to zero and
  they are dropped from the objective).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.snmf import (
    SNMFParams,
    SNMFResult,
    _h_update,
    _w_statistics,
    _w_update_from_stats,
    _prepare,
    _FLR,
)


def make_mesh(n_devices=None, axis_name="dp"):
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(n_dp, n_tp, axis_names=("dp", "tp")):
    """2-D device mesh for combined data x tensor parallelism.

    The tp axis is the faster-varying one, so each tp group is
    consecutive ``jax.devices()`` entries.  On one host the cards are
    joined all to all by NVLink at one rate, so the layout follows the
    algorithm alone: tp psums run K times per time step inside the
    recurrence, dp gradient psums once per step."""
    devices = jax.devices()
    if len(devices) < n_dp * n_tp:
        raise ValueError(
            f"need {n_dp * n_tp} devices for a {n_dp}x{n_tp} mesh, "
            f"have {len(devices)}")
    return Mesh(
        np.array(devices[: n_dp * n_tp]).reshape(n_dp, n_tp), axis_names)


def shard_batch(arrays, mesh, axis_name="dp"):
    sharding = NamedSharding(mesh, P(axis_name))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def replicate_params(params, mesh):
    """Replicate a parameter pytree across the mesh.

    Copies explicitly: ``device_put`` of an already-committed array can
    alias the input buffer, and the donating train step would then delete
    the caller's params along with its own."""
    sharding = NamedSharding(mesh, P())
    return {
        k: jax.device_put(jnp.array(v, copy=True), sharding)
        for k, v in params.items()
    }


def fsdp_param_sharding(value, mesh, axis_name="dp", min_elems=1 << 16):
    """FSDP/ZeRO-3 placement rule for one parameter array: shard its
    LARGEST ``dp``-divisible dimension over the data-parallel axis; small
    or indivisible arrays stay replicated.

    Sharding params (and, by the same rule, their Adam moments) over dp cuts
    per-device HBM for weights + optimizer state by ~1/dp -- the enabler
    for dictionaries that outgrow one card (at 2r=50k the two frozen
    (2r, 2r) U tensors alone are ~20 GB before activations and Adam state;
    see ``utils/memplan.py`` for the closed-form per-layout accounting).
    Exact: XLA all-gathers params where used and reduce-scatters grads, the
    same sum as the replicated layout in a different order.
    """
    n = int(mesh.shape[axis_name])
    shape = jnp.shape(value)
    if n <= 1 or int(np.prod(shape, dtype=np.int64)) < min_elems:
        return NamedSharding(mesh, P())
    cands = [d for d in range(len(shape)) if shape[d] % n == 0]
    if not cands:
        return NamedSharding(mesh, P())
    dim = max(cands, key=lambda d: shape[d])
    spec = [None] * len(shape)
    spec[dim] = axis_name
    return NamedSharding(mesh, P(*spec))


def fsdp_shard_params(params, mesh, axis_name="dp", min_elems=1 << 16):
    """Place a parameter pytree under the FSDP rule (see
    ``fsdp_param_sharding``).  Returns ``(placed_params, shardings)`` --
    the shardings dict is reused as a ``with_sharding_constraint`` target
    inside the train step so updated params keep the sharded layout."""
    shardings = {
        k: fsdp_param_sharding(v, mesh, axis_name, min_elems)
        for k, v in params.items()
    }
    placed = {
        k: jax.device_put(jnp.array(v, copy=True), shardings[k])
        for k, v in params.items()
    }
    return placed, shardings


def _masked_divergence(v, lam, beta, fmask):
    if beta == 1.0:
        d = v * jnp.log(v / lam) - v + lam
    elif beta == 2.0:
        d = (v - lam) ** 2
    elif beta == 0.0:
        d = v / lam - jnp.log(v / lam) - 1.0
    else:
        d = (
            v**beta + (beta - 1.0) * lam**beta - beta * v * lam ** (beta - 1.0)
        ) / (beta * (beta - 1.0))
    return jnp.sum(d * fmask)


def _sharded_core(v, w0, h0, sparsity, w_mask, h_mask, fmask, *, beta,
                  max_iter, conv_eps, axis_name):
    """Per-shard body run under shard_map.  v/h0/fmask hold this shard's
    frames; fmask is (1, n_local) with 1.0 on real frames."""
    update_w = jnp.any(w_mask)
    update_h = jnp.any(h_mask)

    wn = jnp.sqrt(jnp.sum(w0 * w0, axis=0))
    w0 = w0 / wn[None, :]
    h0 = h0 * wn[:, None] * fmask

    if beta != 2.0:
        valid_pos = jnp.logical_and(v > 0, fmask > 0)
        vmin_local = jnp.min(jnp.where(valid_pos, v, jnp.inf))
        vmin = jax.lax.pmin(vmin_local, axis_name)
        v = jnp.where(v == 0, vmin, v)

    lam0 = jnp.maximum(jnp.dot(w0, h0, preferred_element_type=jnp.float32), _FLR)

    def body(carry):
        w, h, lam, last_cost, it, costs, done = carry

        h_new = _h_update(v, w, h, lam, sparsity, h_mask, beta) * fmask
        h = jnp.where(update_h, h_new, h)
        lam = jnp.where(
            update_h,
            jnp.maximum(jnp.dot(w, h, preferred_element_type=jnp.float32), _FLR),
            lam,
        )

        # local statistics -> global via psum over the frame-shard axis.
        # padded frames contribute nothing: their h columns are zero.
        stats = _w_statistics(v, w, h, lam, beta)
        stats = tuple(jax.lax.psum(s, axis_name) for s in stats)
        w_new = _w_update_from_stats(w, stats, w_mask, beta)
        w = jnp.where(update_w, w_new, w)
        lam = jnp.where(
            update_w,
            jnp.maximum(jnp.dot(w, h, preferred_element_type=jnp.float32), _FLR),
            lam,
        )

        div = jax.lax.psum(_masked_divergence(v, lam, beta, fmask), axis_name)
        cost = div + jax.lax.psum(jnp.sum(sparsity * h), axis_name)
        costs = costs.at[it].set(cost)

        converged = jnp.logical_and(
            it > 0,
            jnp.logical_and(
                conv_eps > 0, jnp.abs(cost - last_cost) / last_cost < conv_eps
            ),
        )
        return (w, h, lam, cost, it + 1, costs, converged)

    def cond(carry):
        return jnp.logical_and(carry[4] < max_iter, jnp.logical_not(carry[6]))

    costs = jnp.zeros((max_iter,), jnp.float32)
    init = (w0, h0, lam0, jnp.float32(jnp.inf), jnp.int32(0), costs,
            jnp.bool_(False))
    w, h, lam, _, n_iter, costs, _ = jax.lax.while_loop(cond, body, init)
    return w, h, costs, n_iter


def sparse_nmf_sharded(v, params: SNMFParams, mesh: Mesh, key=None,
                       axis_name="dp") -> SNMFResult:
    """Sparse NMF with frames sharded across the mesh.  All devices hold
    identical dictionaries; H is sharded like v.  Results match the
    single-device engine exactly (modulo fp reduction order)."""
    n_dev = mesh.devices.size
    if key is None:
        key = jax.random.PRNGKey(int(params.random_seed))
    v = np.asarray(v, np.float32)
    m, n = v.shape
    pad = (-n) % n_dev
    fmask = np.ones((1, n + pad), np.float32)
    if pad:
        v = np.concatenate([v, np.zeros((m, pad), np.float32)], axis=1)
        fmask[:, n:] = 0.0
        if params.init_h is not None and not isinstance(params.init_h, str):
            from dataclasses import replace

            init_h = np.asarray(params.init_h, np.float32)
            params = replace(
                params,
                init_h=np.concatenate(
                    [init_h, np.zeros((init_h.shape[0], pad), np.float32)], axis=1
                ),
            )
    w0, h0, sparsity, w_mask, h_mask = _prepare((m, v.shape[1]), params, key)
    if sparsity.ndim == 0:
        sparsity = jnp.broadcast_to(sparsity, (1, 1))

    core = partial(
        _sharded_core,
        beta=params.resolved_beta(),
        max_iter=int(params.max_iter),
        conv_eps=float(params.conv_eps),
        axis_name=axis_name,
    )
    sp_spec = P() if sparsity.shape[1] == 1 else P(None, axis_name)
    sharded = jax.jit(
        jax.shard_map(
            core,
            mesh=mesh,
            in_specs=(P(None, axis_name), P(), P(None, axis_name), sp_spec,
                      P(), P(), P(None, axis_name)),
            out_specs=(P(), P(None, axis_name), P(), P()),
        )
    )
    w, h, costs, n_iter = sharded(
        jnp.asarray(v), w0, h0, sparsity, w_mask, h_mask, jnp.asarray(fmask)
    )
    n_iter = int(n_iter)
    h = np.asarray(h)[:, :n]
    return SNMFResult(
        w=np.asarray(w),
        h=h,
        div=np.asarray(costs)[:n_iter],  # cost series (sharded path keeps one)
        cost=np.asarray(costs)[:n_iter],
        n_iter=n_iter,
    )

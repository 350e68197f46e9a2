"""Tensor-parallel DR-NMF recurrence: hidden dimension sharded over a mesh.

SURVEY.md section 2 notes TP is unnecessary at the paper's r=1000 (the
weights are ~50 MB), but a production dictionary can grow past one chip's
HBM: U and S are (2r, 2r), i.e. 4 GB at r=16k in f32.  This module shards
the 2r axis Megatron-style:

* the LARGE parameters (log_U1, log_Uk -- the only (2r, 2r) tensors) enter
  the sharded computation row-sharded and never exist in full on any device;
  their effective forms ``exp(.)^T`` are local transposes of the row shards
  (a row shard of M is a column shard of M^T).  When the frozen-U fold
  applies (models.drnmf ``fold_frozen_U``: U untrainable, every shipped
  reference config) the U tensors are rank-one constants and are not
  sharded, transferred, or materialized AT ALL -- only a (2r,) diagonal and
  two scalars enter the mesh, and the per-step U matmuls become row-sums;
* the S_k recurrence matrices ((2r, 2r), derived) are materialized ONLY as
  column shards, each built locally from the replicated dictionary D-hat
  (which is (F, 2r) -- small, 33 MB even at r=16k):
  ``S[:, blk] = (I[blk, :] - ((Dhat/alph)[:, blk])^T Dhat)^T``;
* each device computes its (B, 2r/P) slice of every layer's pre-activation
  with local matmuls; the layer output must be visible in full to the next
  contraction, so each layer ends with an ``all_gather`` of the (B, 2r/P)
  hidden slice between devices -- K gathers per timestep, each 1/P'th of the state.

Exact: the math is the single-device recurrence with a different summation
layout; the parity test asserts equality.

``drnmf_scan_tp`` (gather formulation) is inference-only: the
all_gather/varying-type structure is not reverse-mode differentiable under
jax's VMA typing.  ``drnmf_scan_tp_train`` is the differentiable dual
(psum decomposition over the contraction axis; its transpose is
replication) -- gradient parity with the single-device scan is tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.drnmf import _ACTIVATIONS, _precision, u_is_foldable
from ._cache import CompiledCache

# (config, axis, shapes, device ids) -> jitted shard_map; LRU-bounded so a
# long-lived server scanning many batch shapes doesn't leak executables
_COMPILED = CompiledCache()


def drnmf_scan_tp(params, config, x, step_mask, mesh, axis_name="tp"):
    """Hidden states with the 2r axis sharded over ``axis_name``.

    x: (B, T, F); returns (B, T, 2r) hidden states equal to the
    single-device scan, laid out tp-sharded on the hidden axis (each device
    holds its 2r/P slice).  hidden_dim must divide the mesh axis.
    """
    n_tp = mesh.shape[axis_name]
    h_dim = config.hidden_dim
    if h_dim % n_tp:
        raise ValueError(f"hidden_dim={h_dim} not divisible by tp={n_tp}")
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError("tp scan supports the inference cell only")

    K = config.K_layers
    blk = h_dim // n_tp
    prec = _precision(config)
    act = _ACTIVATIONS[config.activation]

    # small per-layer pieces, replicated: Dhat (F, 2r), alph, lam1
    d_names = config.untied_names("log_D")
    a_names = config.untied_names("log_alph")
    l_names = config.untied_names("log_lam1")

    def dhat(k):
        d = jnp.exp(params[d_names[k]])
        return d / jnp.sqrt(jnp.sum(d * d, axis=0, keepdims=True))

    dh_stack = jnp.stack([dhat(k) for k in range(K)])  # (K, F, 2r)
    alph_stack = jnp.stack([
        jnp.broadcast_to(jnp.exp(params[a_names[k]]), (h_dim,))
        for k in range(K)
    ])  # (K, 2r)
    b_stack = jnp.stack([
        -jnp.ones((h_dim,), jnp.float32)
        * jnp.exp(params[l_names[k]]) / jnp.exp(params[a_names[k]])
        for k in range(K)
    ])  # (K, 2r)
    if config.nonnegative:
        h0 = jax.nn.softplus(params["log_h0"])
    else:
        h0 = params["h0"]

    # frozen-U fold (models.drnmf fold_frozen_U): the (2r, 2r) U tensors are
    # rank-one-structured constants, so they are never sharded, transferred,
    # or materialized -- only diag1 (2r,) and two scalars enter the mesh.
    # The rank-one form needs rowsum(h_prev), which is local here because
    # the gathered carry holds the FULL hidden state on every device.
    folded = u_is_foldable(config)
    if folded:
        sg = jax.lax.stop_gradient
        u_a = sg(jnp.exp(jnp.diagonal(params["log_U1"])))  # (2r,)
        u_b = sg(jnp.stack([jnp.exp(params["log_U1"][0, 1]),
                            jnp.exp(params["log_Uk"][0, 0])]))  # off1, c
        u_specs = (P(), P())
    else:
        u_a, u_b = params["log_U1"], params["log_Uk"]
        u_specs = (P(axis_name, None), P(axis_name, None))  # row shards

    def local(u_a, u_b, dh, alph, b_full, x_loc, m_loc, h0_loc):
        # dense mode: u_a/u_b are (2r/P, 2r) ROW shards of the only big
        # tensors; folded mode: u_a = diag1 (2r,), u_b = [off1, c];
        # everything else replicated
        p = jax.lax.axis_index(axis_name)
        start = p * blk
        bsz = x_loc.shape[0]

        if not folded:
            # effective column shards, built locally (never full anywhere):
            u1_loc = jnp.exp(u_a).T       # (2r, 2r/P)
            uk_loc = jnp.exp(u_b).T
        rows = start + jnp.arange(blk)
        eye_rows = (
            rows[:, None]
            == jax.lax.broadcasted_iota(jnp.int32, (blk, h_dim), 1)
        ).astype(jnp.float32)  # I[blk, :]
        s_locs, w_locs, b_locs = [], [], []
        for k in range(K):
            da = dh[k] / alph[k][None, :]  # (F, 2r), replicated
            da_blk = jax.lax.dynamic_slice_in_dim(da, start, blk, axis=1)
            if k > 0:
                m_rows = eye_rows - jnp.dot(
                    da_blk.T, dh[k], precision=prec,
                    preferred_element_type=jnp.float32,
                )  # M[blk, :] with M = I - (Dhat/alph)^T Dhat
                s_locs.append(m_rows.T)  # S[:, blk]
            w_locs.append(da_blk)  # W_k[:, blk] = (Dhat/alph)[:, blk]
            b_locs.append(
                jax.lax.dynamic_slice_in_dim(b_full[k], start, blk, axis=0)
            )

        xT = jnp.swapaxes(x_loc, 0, 1)
        mT = jnp.swapaxes(m_loc, 0, 1)
        h_init = jax.lax.pcast(
            jnp.broadcast_to(h0_loc[None, :], (bsz, h_dim)),
            axis_name, to="varying",
        )  # the carry becomes device-varying after the first all_gather

        def step(h_prev, inp):
            x_t, m_t = inp
            hidden = None
            if folded:
                diag_blk = jax.lax.dynamic_slice_in_dim(u_a, start, blk, 0)
                h_blk = jax.lax.dynamic_slice_in_dim(h_prev, start, blk, 1)
                rs = jnp.sum(h_prev, axis=1, keepdims=True)
                u_first = h_blk * (diag_blk - u_b[0]) + u_b[0] * rs
                u_rest = u_b[1] * rs  # (B, 1), broadcasts against (B, blk)
            for k in range(K):
                if folded:
                    pre = u_first if k == 0 else u_rest
                else:
                    pre = jnp.dot(h_prev, u1_loc if k == 0 else uk_loc,
                                  precision=prec,
                                  preferred_element_type=jnp.float32)
                if k > 0:
                    pre = pre + jnp.dot(hidden, s_locs[k - 1], precision=prec,
                                        preferred_element_type=jnp.float32)
                if config.connect_input_to_layers:
                    pre = pre + jnp.dot(x_t, w_locs[k], precision=prec,
                                        preferred_element_type=jnp.float32)
                local_hidden = act(pre + b_locs[k])  # (B, 2r/P)
                # next layer contracts over the FULL 2r axis
                hidden = jax.lax.all_gather(
                    local_hidden, axis_name, axis=1, tiled=True
                )
            h_new = jnp.where(m_t[:, None], hidden, h_prev)
            # emit only this device's 2r/P slice: the gathered h_new is
            # value-replicated but TYPED device-varying (it flows from
            # sharded weights), so a replicated out_specs would need the
            # check_vma escape hatch -- the varying local slice instead
            # types exactly, and out_specs concatenates the slices back
            # into the full (B, T, 2r) array (tp-sharded on the last axis)
            return h_new, jax.lax.dynamic_slice_in_dim(h_new, start, blk, 1)

        _, hs = jax.lax.scan(step, h_init, (xT, mT))
        return jnp.swapaxes(hs, 0, 1)

    # cache the jitted program: jit keys on the wrapper object, so building
    # a fresh one per call would recompile every invocation
    cache_key = (config, axis_name, tuple(x.shape),
                 tuple(d.id for d in mesh.devices.flat))
    fn = _COMPILED.get(cache_key)
    if fn is None:
        shard = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                *u_specs,            # U row shards, or folded diag+scalars
                P(), P(), P(),       # Dhat stack, alph stack, b stack (small)
                P(), P(), P(),       # x, mask, h0 replicated
            ),
            out_specs=P(None, None, axis_name),
        )
        fn = jax.jit(shard)
        _COMPILED.put(cache_key, fn)
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    return fn(
        put(u_a, u_specs[0]), put(u_b, u_specs[1]),
        put(dh_stack, P()), put(alph_stack, P()), put(b_stack, P()),
        put(x, P()), put(step_mask, P()), put(h0, P()),
    )


def drnmf_scan_tp_train(params, config, x, step_mask, mesh, axis_name="tp"):
    """Differentiable tensor-parallel recurrence (training formulation).

    The inference path above column-shards weights and all_gathers
    activations -- not reverse-mode differentiable under jax's VMA typing.
    This variant uses the dual Megatron decomposition: weights are
    ROW-sharded along the contraction axis, every device computes a partial
    (B, 2r) pre-activation from its h_prev slice, and a ``psum`` across
    the tp devices completes the contraction.  psum's transpose is replication, so
    ``jax.grad`` flows through; the gradient parity test pins equality with
    the single-device scan.

    Comm: K psums of (B, 2r) per timestep (P times the bytes of the
    inference path's gathers -- the price of differentiability).
    """
    _tp_train_validate(config, mesh.shape[axis_name])
    local = _tp_train_local(config, axis_name, mesh.shape[axis_name])
    # VMA-typed (no check_vma escape hatch): every cross-device value flows
    # through a psum, which removes the device-varying type, so the
    # replicated out_specs is verified by the type system -- unlike the
    # gather formulation above, whose all_gather output stays typed varying.
    shard = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P()),  # params/x/mask replicated; compute sharded
        out_specs=P(),
    )
    return shard(params, x, step_mask)


def _tp_train_validate(config, n_tp):
    if config.hidden_dim % n_tp:
        raise ValueError(
            f"hidden_dim={config.hidden_dim} not divisible by tp={n_tp}")
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError("tp scan supports the plain cell only")


def _tp_train_local(config, axis_name, n_tp, vary_axes=()):
    """Per-device body of the dual (row-sharded/psum) TP recurrence; shared
    by the 1-D ``drnmf_scan_tp_train`` and the 2-D ``drnmf_apply_tp_dp``.

    ``vary_axes`` names mesh axes the INPUT batch is sharded over (dp in the
    2-D layout): the scan carry starts from the replicated h0 but becomes
    varying over those axes after mixing with x, so the initial carry is
    pcast to the varying type up front (VMA carry types must be loop
    -invariant)."""
    h_dim = config.hidden_dim
    K = config.K_layers
    blk = h_dim // n_tp
    prec = _precision(config)
    act = _ACTIVATIONS[config.activation]

    def local(params_loc, x_loc, m_loc):
        # params_loc: alt params with log_U1/log_Uk ROW-sharded (2r/P, 2r);
        # everything else replicated (small)
        p = jax.lax.axis_index(axis_name)
        start = p * blk
        bsz = x_loc.shape[0]

        d_names = config.untied_names("log_D")
        a_names = config.untied_names("log_alph")
        l_names = config.untied_names("log_lam1")

        def dhat(k):
            d = jnp.exp(params_loc[d_names[k]])
            return d / jnp.sqrt(jnp.sum(d * d, axis=0, keepdims=True))

        # h @ U decomposes over the contraction axis:
        # h @ U = sum_p h[:, seg_p] @ U[seg_p, :] with
        # U[seg_p, :] = (exp(log_U)[:, seg_p])^T.  Params stay replicated
        # (gradient simplicity); only the compute/comm is sharded -- true
        # weight-sharded training composes this with FSDP-style parameter
        # sharding.
        h0 = (jax.nn.softplus(params_loc["log_h0"])
              if config.nonnegative else params_loc["h0"])

        def seg(mat_exp):
            # rows seg_p of U = exp(log_U)^T -> exp(log_U[:, seg])^T
            cols = jax.lax.dynamic_slice_in_dim(mat_exp, start, blk, axis=1)
            return cols.T  # (blk, 2r)

        # frozen-U fold (models.drnmf fold_frozen_U): U is a rank-one
        # stop_gradient constant; its contribution is computed locally from
        # the replicated full h_prev (no psum share) -- layer 1 then needs
        # no collective at all.
        folded = u_is_foldable(config)
        if folded:
            sg = jax.lax.stop_gradient
            u_diag1 = sg(jnp.exp(jnp.diagonal(params_loc["log_U1"])))
            u_off1 = sg(jnp.exp(params_loc["log_U1"][0, 1]))
            u_c = sg(jnp.exp(params_loc["log_Uk"][0, 0]))
        else:
            u1_seg = seg(jnp.exp(params_loc["log_U1"]))
            uk_seg = seg(jnp.exp(params_loc["log_Uk"]))

        s_segs, w_parts, b_full = [], [], []
        for k in range(K):
            dk = dhat(k)
            alph = jnp.exp(params_loc[a_names[k]])
            da = dk / alph  # (F, 2r)
            if k > 0:
                # S = (I - (Dhat/alph)^T Dhat)^T; rows seg_p of S =
                # (I[:, seg] - (Dhat/alph)^T Dhat[:, seg])^T
                dk_seg = jax.lax.dynamic_slice_in_dim(dk, start, blk, axis=1)
                eye_seg = (
                    jax.lax.broadcasted_iota(jnp.int32, (h_dim, blk), 0)
                    == (start + jnp.arange(blk))[None, :]
                ).astype(jnp.float32)
                m_cols = eye_seg - jnp.dot(
                    da.T, dk_seg, precision=prec,
                    preferred_element_type=jnp.float32,
                )  # (2r, blk) = M[:, seg]
                s_segs.append(m_cols.T)  # rows seg of S
            w_parts.append(da)  # full W_k (small) -- x term stays local
            b_full.append(
                -jnp.ones((h_dim,), jnp.float32)
                * jnp.exp(params_loc[l_names[k]]) / alph
            )

        xT = jnp.swapaxes(x_loc, 0, 1)
        mT = jnp.swapaxes(m_loc, 0, 1)
        h_init = jnp.broadcast_to(h0[None, :], (bsz, h_dim))
        if vary_axes:
            h_init = jax.lax.pcast(h_init, vary_axes, to="varying")

        def step(h_prev, inp):
            x_t, m_t = inp
            hidden = None
            if folded:
                rs = jnp.sum(h_prev, axis=1, keepdims=True)
                u_first = h_prev * (u_diag1 - u_off1) + u_off1 * rs  # (B, 2r)
                u_rest = u_c * rs  # (B, 1)
            for k in range(K):
                if folded:
                    pre = u_first if k == 0 else u_rest
                    if k > 0:
                        hid_seg = jax.lax.dynamic_slice_in_dim(
                            hidden, start, blk, axis=1)
                        pre = pre + jax.lax.psum(
                            jnp.dot(hid_seg, s_segs[k - 1], precision=prec,
                                    preferred_element_type=jnp.float32),
                            axis_name)
                else:
                    useg = u1_seg if k == 0 else uk_seg
                    h_seg = jax.lax.dynamic_slice_in_dim(
                        h_prev, start, blk, axis=1)
                    part = jnp.dot(h_seg, useg, precision=prec,
                                   preferred_element_type=jnp.float32)
                    if k > 0:
                        hid_seg = jax.lax.dynamic_slice_in_dim(
                            hidden, start, blk, axis=1)
                        part = part + jnp.dot(hid_seg, s_segs[k - 1],
                                              precision=prec,
                                              preferred_element_type=jnp.float32)
                    pre = jax.lax.psum(part, axis_name)
                if config.connect_input_to_layers:
                    pre = pre + jnp.dot(x_t, w_parts[k], precision=prec,
                                        preferred_element_type=jnp.float32)
                hidden = act(pre + b_full[k])
            h_new = jnp.where(m_t[:, None], hidden, h_prev)
            return h_new, h_new

        _, hs = jax.lax.scan(step, h_init, (xT, mT))
        return jnp.swapaxes(hs, 0, 1)

    return local


def drnmf_apply_tp_dp(params, config, x, step_mask, mesh,
                      dp_axis="dp", tp_axis="tp"):
    """Full DR-NMF forward (recurrence + heads + ratio mask) on a 2-D
    ``(dp, tp)`` mesh -- the production sharding when the batch outgrows
    one chip AND the dictionary outgrows one chip's HBM.

    Batch rows are sharded over ``dp``; within each dp row the recurrence
    contraction is sharded over ``tp`` (one (B/dp, 2r) psum per unfold,
    among the tp devices only).  The heads and ratio mask are
    local small matmuls on the psum-complete hidden states.  Exact: the
    math is the single-device ``drnmf_forward`` with a different summation
    layout (parity + gradient parity tested).  Differentiable end-to-end:
    the loss's VJP inserts the dp-gradient psum through shard_map's
    transpose, so ``jax.grad`` of a loss on this output is the standard
    data-parallel gradient with tensor-sharded compute.
    """
    from ..models.drnmf import _heads, _ratio_mask

    _tp_train_validate(config, mesh.shape[tp_axis])
    hidden_local = _tp_train_local(config, tp_axis, mesh.shape[tp_axis],
                                   vary_axes=(dp_axis,))

    def local(params_loc, x_loc, m_loc):
        hs = hidden_local(params_loc, x_loc, m_loc)
        clean_est, noise_est = _heads(params_loc, config, hs)
        return _ratio_mask(clean_est, noise_est, config.transform_before_irm)

    shard = jax.shard_map(
        local,
        mesh=mesh,
        # params replicated; batch sharded over dp, replicated over tp.
        # Output varies over dp only: the psum removed the tp-varying type.
        in_specs=(P(), P(dp_axis), P(dp_axis)),
        out_specs=P(dp_axis),
    )
    return shard(params, x, step_mask)

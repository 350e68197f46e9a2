"""Training loop: optax Adam with Keras-compatible semantics, per-parameter
trainability, early stopping, best-only checkpointing, full metric history.

Reference behaviors reproduced (enhance.py:1040-1166):

* Adam(lr, clipnorm, decay) -- Keras 2.0.4 decay schedule
  ``lr_t = lr / (1 + decay * iteration)``; global-norm clipping when
  ``clipnorm > 0``.
* per-parameter trainability (``params_trainable`` semantics) via a masked
  optimizer -- frozen alt-params receive zero updates.
* ``EarlyStopping(val_loss, patience)`` and best-val-loss-only weight saving;
  history pickled each epoch (LossHistory).
* batch shuffling each epoch (Keras fit default).

The train step is one jit'd program (forward + backward + Adam); batches
stream host->device per step, and with a provided ``jax.sharding.Mesh``
the step shards the batch axis over the 'dp' mesh axis (gradients are
reduced by XLA-inserted collectives).
"""

import os
import pickle
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .history import LossHistory
from .checkpoint import save_checkpoint


def _frozen_fingerprint(value):
    """Cheap content fingerprint of a frozen parameter (float64 sum + shape).
    Guards resume against a different warm-start dictionary/init than the
    original run: frozen values are reconstituted from the caller's params,
    so a silent mismatch would mix new frozen values with checkpointed
    trainable params and optimizer state."""
    v = np.asarray(value, np.float64)
    return (tuple(v.shape), float(v.sum()), float(np.abs(v).sum()))


def _save_train_state(path, epoch, params, opt_state, best_params, best_val,
                      wait, global_step, finished=False, trainable_mask=None):
    """Full training state for elastic resume (written atomically).

    With ``trainable_mask``, frozen parameters are NOT persisted (they
    cannot change -- the optimizer gives them zero updates) and are
    reconstituted from the caller's initial params at load.  This matters
    in practice: the flagship model's frozen log_U1/log_Uk are (2r, 2r) --
    ~32 MB that would otherwise be fetched from device and pickled every
    epoch, more than the trainable state of a small corpus's epoch."""
    keep = ((lambda k: bool(trainable_mask.get(k, True)))
            if trainable_mask else (lambda k: True))
    flat_opt, treedef = jax.tree.flatten(opt_state)
    frozen_keys = sorted(k for k in params if not keep(k))
    state = {
        "epoch": epoch,
        "params": {k: np.asarray(v) for k, v in params.items() if keep(k)},
        "opt_leaves": [np.asarray(x) for x in flat_opt],
        "best_params": {k: np.asarray(v) for k, v in best_params.items()
                        if keep(k)},
        "frozen_keys": frozen_keys,
        "frozen_fingerprint": {k: _frozen_fingerprint(params[k])
                               for k in frozen_keys},
        "best_val": float(best_val),
        "wait": int(wait),
        "global_step": int(global_step),
        "finished": bool(finished),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


class TrainingDeadline(RuntimeError):
    """Raised at an epoch boundary when env ``DRNMF_TRAIN_DEADLINE_TS``
    (a unix timestamp) has passed and elastic-resume state is on disk.

    A run with a wall-clock budget stops at an epoch boundary instead of
    being killed mid-epoch and losing it: the run aborts cleanly with the
    state just saved, and a later invocation resumes exactly."""


def train_state_incomplete(savefile, epochs, patience):
    """True if an elastic-resume state exists for ``savefile`` and the run
    it belongs to still has epochs to train (not early-stopped, epoch count
    not yet reached) -- the pipeline's signal that training must re-enter
    train_model even though a best checkpoint already exists."""
    path = savefile + ".train_state"
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("finished") or state["wait"] > patience:
        return False
    return state["epoch"] + 1 < epochs


def _load_train_state(path, opt_state_template, frozen_source=None):
    """``frozen_source``: params dict supplying the values of
    ``frozen_keys`` (the run's initial params -- frozen values are
    identical by construction)."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    fingerprints = state.get("frozen_fingerprint", {})
    for k in state.get("frozen_keys", []):
        if frozen_source is None or k not in frozen_source:
            raise ValueError(
                f"train state {path} omits frozen param '{k}' but no "
                f"frozen_source provides it")
        if k in fingerprints:
            got = _frozen_fingerprint(frozen_source[k])
            if got != fingerprints[k]:
                raise ValueError(
                    f"frozen param '{k}' differs from the run that wrote "
                    f"{path} (fingerprint {got} != {fingerprints[k]}): "
                    f"resuming would silently mix a different warm-start "
                    f"dictionary/init with the checkpointed trainable state. "
                    f"Delete the train state to restart, or restore the "
                    f"original initialization.")
        state["params"][k] = np.asarray(frozen_source[k])
        state["best_params"][k] = np.asarray(frozen_source[k])
    _, treedef = jax.tree.flatten(opt_state_template)
    opt_state = jax.tree.unflatten(treedef, state["opt_leaves"])
    return state, opt_state


@dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 1e-3
    clipnorm: float = 0.0
    decay: float = 0.0
    patience: int = 50
    seed: int = 7654
    verbose: bool = True


def make_optimizer(train_config: TrainConfig, trainable_mask: Optional[dict] = None):
    """Keras-Adam-compatible optax chain with optional parameter freezing."""

    def lr_schedule(step):
        return train_config.learning_rate / (1.0 + train_config.decay * step)

    chain = []
    if train_config.clipnorm and train_config.clipnorm > 0:
        chain.append(optax.clip_by_global_norm(train_config.clipnorm))
    chain.append(optax.adam(lr_schedule, b1=0.9, b2=0.999, eps=1e-8))
    opt = optax.chain(*chain)
    if trainable_mask is not None:
        opt = optax.multi_transform(
            {"train": opt, "freeze": optax.set_to_zero()},
            {k: ("train" if v else "freeze") for k, v in trainable_mask.items()},
        )
    return opt


def _shard_batch(batch, mesh):
    """Async host->device transfer (device_put dispatches without blocking,
    so issuing batch i+1's transfer before batch i's step completes
    double-buffers input against compute).

    With a mesh, rows shard over the 'dp' axis; a partial batch is padded
    with zero rows (mask included) to a multiple of the axis size -- padded
    rows carry zero mask, so both the masked losses and their gradients are
    unchanged (the mask sum only counts real frames)."""
    if mesh is None:
        return tuple(jax.device_put(b) for b in batch)
    from jax.sharding import NamedSharding, PartitionSpec as P

    # pad to the BATCH-sharding axis only: on a 2-D (dp, tp) mesh rows
    # shard over dp and replicate over tp
    n_dp = int(mesh.shape.get("dp", mesh.devices.size))
    pad = (-batch[0].shape[0]) % n_dp
    if pad:
        batch = tuple(
            np.concatenate(
                [b, np.zeros((pad,) + b.shape[1:], b.dtype)], axis=0
            )
            for b in batch
        )
    sharding = NamedSharding(mesh, P("dp"))
    return tuple(jax.device_put(b, sharding) for b in batch)


def make_train_step(loss_fn: Callable, optimizer, with_rng: bool = False,
                    accumulate_loss: bool = False, param_shardings=None):
    """loss_fn(params, x, y, mask[, rng]) -> scalar.  Returns jit'd step.

    ``with_rng=True`` threads a per-batch PRNG key into the loss (variational
    dropout in the DR-NMF cell, custom_layers.py:377-395 semantics).

    Params and optimizer state are donated: XLA updates them in place
    instead of allocating fresh buffers every step.

    ``accumulate_loss=True`` changes the signature to
    ``step(params, opt_state, loss_buf, step_ix, x, y, mask[, rng]) ->
    (params, opt_state, loss_buf)``: the batch loss is written into the
    donated device buffer ``loss_buf`` at ``step_ix`` instead of being
    returned as a scalar.  This is what lets the training loop dispatch
    every step of an epoch without a single host<->device synchronization
    (fetching the loss scalar per step would block the host on every
    step); per-batch history values are identical -- they are fetched once
    per epoch.

    ``param_shardings`` (a pytree of ``NamedSharding`` matching params, from
    ``fsdp_shard_params``) pins the UPDATED params to the FSDP layout:
    without the constraint GSPMD may resolve the all-gather(param) ->
    grad -> update cycle to a replicated output, silently un-sharding the
    optimizer state after the first step."""

    def _constrain(p):
        if param_shardings is None:
            return p
        return jax.lax.with_sharding_constraint(p, param_shardings)

    if accumulate_loss:
        @partial(jax.jit, donate_argnums=(0, 1, 2))
        def step_acc(params, opt_state, loss_buf, step_ix, x, y, mask,
                     rng=None):
            if with_rng:
                loss, grads = jax.value_and_grad(loss_fn)(params, x, y, mask,
                                                          rng)
            else:
                loss, grads = jax.value_and_grad(loss_fn)(params, x, y, mask)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = _constrain(optax.apply_updates(params, updates))
            return params, opt_state, loss_buf.at[step_ix].set(loss)

        return step_acc

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, x, y, mask, rng=None):
        if with_rng:
            loss, grads = jax.value_and_grad(loss_fn)(params, x, y, mask, rng)
        else:
            loss, grads = jax.value_and_grad(loss_fn)(params, x, y, mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = _constrain(optax.apply_updates(params, updates))
        return params, opt_state, loss

    return step


def make_epoch_chunk(loss_fn: Callable, optimizer, with_rng: bool = False):
    """A CHUNK of an epoch as ONE device program: ``lax.scan`` over S
    full-size batches, gathering each batch from the device-resident split
    by shuffled indices.  Per-step host dispatch (the residual loop cost
    once the per-step loss fetch was removed) drops to one dispatch per S
    steps.  Same math as S calls of the per-step
    program: same gathers, same step body, same Adam update; dropout keys
    derive from the SAME ``fold_in(base_key, global_step)`` schedule.

    Returns ``chunk(params, opt_state, x, y, mask, idx, step0[, base_key])
    -> (params, opt_state, losses)`` with ``idx`` (S, B) int32 and
    ``losses`` (S,) staying on device (fetch once per epoch).
    Only used on the mesh-free device-resident path (train_model)."""

    def body_factory(x, y, mask, step0, base_key):
        def body(carry, inp):
            params, opt_state = carry
            idx, i = inp
            xb, yb, mb = x[idx], y[idx], mask[idx]
            if with_rng:
                key = jax.random.fold_in(base_key, step0 + i)
                loss, grads = jax.value_and_grad(loss_fn)(
                    params, xb, yb, mb, key)
            else:
                loss, grads = jax.value_and_grad(loss_fn)(params, xb, yb, mb)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        return body

    @partial(jax.jit, donate_argnums=(0, 1))
    def chunk(params, opt_state, x, y, mask, idx, step0, base_key=None):
        body = body_factory(x, y, mask, step0, base_key)
        steps = jnp.arange(idx.shape[0], dtype=jnp.int32)
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (idx, steps))
        return params, opt_state, losses

    return chunk


def make_eval_step(loss_fn: Callable):
    @jax.jit
    def step(params, x, y, mask):
        return loss_fn(params, x, y, mask)

    return step


def evaluate(eval_step, params, data, batch_size=250, mesh=None):
    """Masked-mean loss over a whole split, aggregated exactly (weighted by
    valid-frame counts per batch)."""
    x, y, mask = data
    total, weight = 0.0, 0.0
    for start in range(0, x.shape[0], batch_size):
        xb = x[start : start + batch_size]
        yb = y[start : start + batch_size]
        mb = mask[start : start + batch_size]
        # .sum() stays device-side when the split is device-resident (an
        # np.sum would fetch the whole mask batch to the host every epoch);
        # for numpy inputs it is the same host reduction
        w = float((mb[..., 0] if mb.ndim == 3 else mb).sum())
        xb, yb, mb = _shard_batch((xb, yb, mb), mesh)
        loss = float(eval_step(params, xb, yb, mb))
        total += loss * w
        weight += w
    return total / max(weight, 1.0)


def train_model(
    params: dict,
    loss_fn: Callable,
    train_data,
    valid_data,
    train_config: TrainConfig,
    trainable_mask: Optional[dict] = None,
    savefile: Optional[str] = None,
    histfile: Optional[str] = None,
    mesh=None,
    eval_loss_fn: Optional[Callable] = None,
    loss_takes_rng: bool = False,
    resume: bool = False,
    fsdp: bool = False,
    fsdp_min_elems: int = 1 << 16,
):
    """Fit with early stopping; returns (best_params, history).

    ``train_data`` / ``valid_data``: (x, y, mask) numpy tensors.
    With ``loss_takes_rng`` the training loss receives a fresh PRNG key per
    batch (dropout); validation uses ``eval_loss_fn`` (defaults to
    ``loss_fn``), always rng-free -- Keras in_train_phase semantics.

    ``resume=True`` (requires ``savefile``) checkpoints the FULL training
    state (params, Adam moments, early-stop counters, epoch) after every
    epoch and, if a state file exists, continues from it EXACTLY as if the
    run had never stopped: the host RNG is fast-forwarded so batch
    permutations (and dropout keys, which derive from the global step) of
    the completed epochs are replayed, not re-drawn.  The reference had no
    equivalent -- a killed run restarted from epoch 0 (best weights were
    kept but optimizer state and schedule were lost).

    ``fsdp=True`` (requires ``mesh``) shards params -- and, by the same
    explicit shape-based placement, the Adam moments -- over the 'dp' axis
    instead of replicating them (ZeRO-3 layout,
    ``parallel.mesh.fsdp_shard_params``; tensors under ``fsdp_min_elems``
    elements stay replicated):
    per-device weight+optimizer HBM drops ~1/dp, enabling dictionaries that
    outgrow one chip.  Numerically it is the same training run (XLA
    all-gathers params at use and reduce-scatters gradients; trajectory
    parity with the replicated layout is pinned by test).
    """
    # the train step donates its params/opt_state buffers; work on copies so
    # the caller's arrays stay valid
    param_shardings = None
    if fsdp and mesh is None:
        raise ValueError("fsdp=True requires a device mesh")
    if fsdp:
        from ..parallel.mesh import fsdp_shard_params

        params, param_shardings = fsdp_shard_params(
            params, mesh, min_elems=fsdp_min_elems)
    elif mesh is not None:
        from ..parallel.mesh import replicate_params

        params = replicate_params(params, mesh)
    else:
        params = {k: jnp.array(v, copy=True) for k, v in params.items()}
    optimizer = make_optimizer(train_config, trainable_mask)
    opt_state = optimizer.init(params)
    if fsdp:
        # place the moments by the SAME shape-based rule as the params:
        # mu/nu mirror param shapes -> identical shardings; scalars (count)
        # replicate over the mesh.  (jit'ing optimizer.init does NOT
        # propagate input shardings -- the zeros outputs have no data
        # dependence on the params and get constant-folded onto one device.)
        from ..parallel.mesh import fsdp_param_sharding

        opt_shardings = jax.tree.map(
            lambda v: fsdp_param_sharding(v, mesh, min_elems=fsdp_min_elems),
            opt_state)
        opt_state = jax.tree.map(
            lambda v, s: jax.device_put(jnp.asarray(v), s),
            opt_state, opt_shardings)
    step_fn = make_train_step(loss_fn, optimizer, with_rng=loss_takes_rng,
                              accumulate_loss=True,
                              param_shardings=param_shardings)
    eval_fn = make_eval_step(eval_loss_fn if eval_loss_fn is not None else loss_fn)
    state_file = (savefile + ".train_state") if (resume and savefile) else None
    resuming = bool(state_file and os.path.exists(state_file))
    history = LossHistory(histfile, resume=resuming)
    base_key = jax.random.PRNGKey(train_config.seed) if loss_takes_rng else None
    global_step = 0

    x, y, mask = train_data
    n = x.shape[0]
    device_resident = False
    if mesh is None and sum(
        t.nbytes for t in (x, y, mask, *valid_data)
    ) <= float(os.environ.get("DRNMF_DEVICE_DATA_MAX_BYTES", 2e9)):
        # Device-resident splits (DESIGN §8): splits up to the
        # DRNMF_DEVICE_DATA_MAX_BYTES gate (2 GB, a fixed constant for
        # now) are uploaded ONCE, and per-epoch batch "transfers" become
        # device-side gathers over the shuffled index instead of
        # re-uploading ~2x the corpus bytes every epoch.  Numerically
        # identical; larger corpora keep the streaming double-buffered
        # host path.
        x, y, mask = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
        valid_data = tuple(jnp.asarray(v) for v in valid_data)
        device_resident = True
    rng = np.random.default_rng(train_config.seed)

    # Epoch fusion (device-resident splits only): run chunks of
    # DRNMF_EPOCH_FUSE_CHUNK full batches as ONE scan program each, so
    # host dispatch amortizes over the chunk (the per-step dispatch was
    # the residual loop-vs-step gap once the loss fetch moved on device).
    # The ragged last batch (n % B) keeps the per-step program.
    epoch_fuse = (device_resident
                  and int(os.environ.get("DRNMF_EPOCH_FUSE", "1")))
    fuse_chunk = max(1, int(os.environ.get("DRNMF_EPOCH_FUSE_CHUNK", "64")))
    chunk_fn = (make_epoch_chunk(loss_fn, optimizer,
                                 with_rng=loss_takes_rng)
                if epoch_fuse else None)

    best_val = np.inf
    # frozen params never change: fetch them from device ONCE; per-epoch
    # best-params/state snapshots fetch only the trainable entries
    frozen_np = ({k: np.asarray(v) for k, v in params.items()
                  if not trainable_mask.get(k, True)}
                 if trainable_mask else {})

    def snapshot(p):
        return {**frozen_np,
                **{k: np.asarray(v) for k, v in p.items()
                   if k not in frozen_np}}

    # Disk-write cadence for the best checkpoint + resume state.  The
    # per-epoch writes fetch every trainable param (and, for the state,
    # both Adam moments) host-side, which can cost more than a small
    # corpus's epoch of training.  DRNMF_STATE_EVERY=N writes every N
    # epochs; the best params are tracked as DEVICE-side copies (jnp.copy,
    # no transfer) and materialized only when a write is due or the fit
    # exits (end / early stop / deadline), so a crash loses at most N-1
    # epochs of resume progress and nothing else.  Default 1 = every-epoch
    # artifacts, byte-identical.
    save_every = max(1, int(os.environ.get("DRNMF_STATE_EVERY", "1")))

    best_params = snapshot(params)  # host dict until the first improvement
    best_dirty = False  # best checkpoint on disk is stale

    def materialize():
        # best_params may hold device arrays (jnp.copy refs); fetch once
        nonlocal best_params, best_dirty
        if best_dirty:
            best_params = snapshot(best_params)
        return best_params

    wait = 0
    start_epoch = 0

    if resuming:
        state, opt_state = _load_train_state(state_file, opt_state,
                                             frozen_source=frozen_np or None)
        if fsdp:
            params = {
                k: jax.device_put(jnp.asarray(v), param_shardings[k])
                for k, v in state["params"].items()
            }
            opt_state = jax.tree.map(
                lambda v, s: jax.device_put(jnp.asarray(v), s),
                opt_state, opt_shardings,
            )
        elif mesh is not None:
            from ..parallel.mesh import replicate_params

            params = replicate_params(state["params"], mesh)
        else:
            params = {k: jnp.asarray(v) for k, v in state["params"].items()}
        if mesh is not None and not fsdp:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(mesh, P())
            opt_state = jax.tree.map(
                lambda v: jax.device_put(jnp.asarray(v), rep), opt_state
            )
        best_params = state["best_params"]
        best_val = state["best_val"]
        wait = state["wait"]
        global_step = state["global_step"]
        start_epoch = state["epoch"] + 1
        if state.get("finished") or wait > train_config.patience:
            # the interrupted run had already finished (naturally or by
            # early stop): do not train further
            start_epoch = train_config.epochs
        # fast-forward the host RNG past the completed epochs so the batch
        # permutations of the remaining epochs match the uninterrupted run
        for _ in range(start_epoch):
            rng.permutation(n)
        if train_config.verbose:
            print(f"resuming from epoch {start_epoch} "
                  f"(best val_loss {best_val:.6f})")

    # per-epoch device loss accumulator: every step writes its loss into
    # this donated buffer on device; the host fetches it ONCE per epoch.
    # (Fetching the scalar per step would serialize host and device;
    # history values are bit-identical either way.)
    n_steps_per_epoch = len(range(0, n, train_config.batch_size))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        loss_buf = jax.device_put(
            jnp.zeros(max(n_steps_per_epoch, 1), jnp.float32),
            NamedSharding(mesh, P()))
    else:
        loss_buf = jnp.zeros(max(n_steps_per_epoch, 1), jnp.float32)

    for epoch in range(start_epoch, train_config.epochs):
        t0 = time.time()
        order = rng.permutation(n)
        starts = list(range(0, n, train_config.batch_size))
        n_batches = len(starts)
        bsz = train_config.batch_size
        if epoch_fuse:
            # chunks of full batches as single scan programs.  Every fused
            # chunk has the SAME (S, B) shape so the chunk program compiles
            # exactly once: small epochs run as one chunk of n_full; large
            # epochs run uniform fuse_chunk-sized chunks and the leftover
            # full batches (n_full % fuse_chunk) go through the per-step
            # program (a handful of dispatches vs a second XLA compile of
            # the fused program).  The ragged last batch (n % B), if any,
            # is per-step as before.
            n_full = n // bsz
            n_fused = (n_full if n_full <= fuse_chunk
                       else (n_full // fuse_chunk) * fuse_chunk)
            parts = []
            if n_fused:
                idx_all = order[: n_fused * bsz].reshape(
                    n_fused, bsz).astype(np.int32)
                for c0 in range(0, n_fused, fuse_chunk):
                    idx_c = jnp.asarray(idx_all[c0 : c0 + fuse_chunk])
                    args = (params, opt_state, x, y, mask, idx_c,
                            jnp.int32(global_step))
                    if loss_takes_rng:
                        params, opt_state, losses = chunk_fn(*args, base_key)
                    else:
                        params, opt_state, losses = chunk_fn(*args)
                    parts.append(losses)
                    global_step += int(idx_c.shape[0])
            for bi in range(n_fused, n_full):  # leftover FULL batches
                idx_b = order[bi * bsz : (bi + 1) * bsz]
                batch = (x[idx_b], y[idx_b], mask[idx_b])
                if loss_takes_rng:
                    key = jax.random.fold_in(base_key, global_step)
                    params, opt_state, loss_buf = step_fn(
                        params, opt_state, loss_buf, np.int32(0), *batch,
                        key)
                else:
                    params, opt_state, loss_buf = step_fn(
                        params, opt_state, loss_buf, np.int32(0), *batch)
                global_step += 1
                parts.append(loss_buf[:1])
            if n % bsz:
                idx_rem = order[n_full * bsz :]
                batch = (x[idx_rem], y[idx_rem], mask[idx_rem])
                if loss_takes_rng:
                    key = jax.random.fold_in(base_key, global_step)
                    params, opt_state, loss_buf = step_fn(
                        params, opt_state, loss_buf, np.int32(0), *batch,
                        key)
                else:
                    params, opt_state, loss_buf = step_fn(
                        params, opt_state, loss_buf, np.int32(0), *batch)
                global_step += 1
                parts.append(loss_buf[:1])
            # ONE host fetch for the whole epoch's per-batch losses
            batch_losses = (np.asarray(jnp.concatenate(parts))
                            if parts else np.zeros(0, np.float32))
        else:
            # prefetch: issue batch i+1's host->device transfer before
            # running step i (device_put is async, so the copy overlaps
            # the step)
            def fetch(start):
                idx = order[start : start + bsz]
                return _shard_batch((x[idx], y[idx], mask[idx]), mesh)

            next_batch = fetch(starts[0]) if starts else None
            for bi, start in enumerate(starts):
                batch = next_batch
                if bi + 1 < len(starts):
                    next_batch = fetch(starts[bi + 1])
                if loss_takes_rng:
                    key = jax.random.fold_in(base_key, global_step)
                    params, opt_state, loss_buf = step_fn(
                        params, opt_state, loss_buf, np.int32(bi), *batch,
                        key)
                else:
                    params, opt_state, loss_buf = step_fn(
                        params, opt_state, loss_buf, np.int32(bi), *batch)
                global_step += 1

            # ONE host fetch for the whole epoch's per-batch losses
            batch_losses = np.asarray(loss_buf)[:n_batches]
        epoch_loss = 0.0  # summed sequentially: bit-identical to the old
        for bl in batch_losses:  # per-step float() accumulation
            history.on_batch_end({"loss": float(bl)})
            epoch_loss += float(bl)

        val_loss = evaluate(eval_fn, params, valid_data, mesh=mesh)
        history.on_epoch_end(
            {"loss": epoch_loss / max(n_batches, 1), "val_loss": val_loss}
        )
        if train_config.verbose:
            print(
                f"epoch {epoch + 1}/{train_config.epochs}: "
                f"loss {epoch_loss / max(n_batches, 1):.6f} "
                f"val_loss {val_loss:.6f} ({time.time() - t0:.1f}s)"
            )

        if val_loss < best_val:
            best_val = val_loss
            # device-side copy: no host fetch (params buffers are donated
            # by the next step, so copy, don't alias)
            best_params = {k: jnp.copy(v) for k, v in params.items()}
            best_dirty = True
            wait = 0
        else:
            wait += 1

        stopping = wait > train_config.patience
        deadline = float(os.environ.get("DRNMF_TRAIN_DEADLINE_TS", "0"))
        deadline_hit = (state_file and deadline and time.time() > deadline
                        and epoch + 1 < train_config.epochs)
        write_due = (stopping or deadline_hit
                     or (epoch + 1) % save_every == 0
                     or epoch + 1 == train_config.epochs)

        if write_due:
            if best_dirty:
                materialize()
                if savefile is not None:
                    save_checkpoint(savefile, best_params,
                                    meta={"val_loss": best_val})
                best_dirty = False
            # on early stop the finished=True write below supersedes this
            # one -- don't pay the multi-second param/opt fetch twice
            if state_file and not stopping:
                _save_train_state(state_file, epoch, params, opt_state,
                                  best_params, best_val, wait, global_step,
                                  trainable_mask=trainable_mask)

        if stopping:
            if train_config.verbose:
                print(f"early stopping at epoch {epoch + 1}")
            if state_file:
                # 'finished' records EARLY STOP only: a run that merely hit
                # its configured epoch count can be extended later by
                # resuming with a larger `epochs`
                _save_train_state(state_file, epoch, params, opt_state,
                                  best_params, best_val, wait, global_step,
                                  finished=True,
                                  trainable_mask=trainable_mask)
            break

        if deadline_hit:
            raise TrainingDeadline(
                f"training deadline passed at epoch {epoch + 1}/"
                f"{train_config.epochs}; state saved — resume to continue")

    if train_config.epochs == 0 and savefile is not None:
        # reference quirk kept on purpose: epochs=0 snapshots initialization
        # (enhance.py:1159-1160)
        save_checkpoint(savefile, best_params, meta={"val_loss": np.inf})

    return materialize(), history

"""Multi-device tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from drnmf_tpu.parallel import make_mesh, shard_batch, replicate_params, sparse_nmf_sharded
from drnmf_tpu.ops import SNMFParams, sparse_nmf


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_nmf_matches_single_device(rng):
    m, n, r = 16, 100, 6  # n not divisible by 8 -> exercises the pad mask
    w0 = rng.uniform(0.1, 1.0, (m, r)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (r, n)).astype(np.float32)
    v = (w0 @ h0 + 0.01 * rng.uniform(size=(m, n))).astype(np.float32)
    params = SNMFParams(r=r, cf="ed", sparsity=0.4, max_iter=25,
                        init_w=w0, init_h=h0)
    single = sparse_nmf(v, params)
    mesh = make_mesh()
    sharded = sparse_nmf_sharded(v, params, mesh)
    np.testing.assert_allclose(sharded.w, single.w, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(sharded.h, single.h, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(sharded.cost, single.cost, rtol=1e-3)


@pytest.mark.parametrize("cf", ["kl"])
def test_sharded_nmf_kl_pad_mask(rng, cf):
    """beta != 2 exercises the pmin v-floor + masked divergence."""
    m, n, r = 12, 50, 4
    w0 = rng.uniform(0.1, 1.0, (m, r)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (r, n)).astype(np.float32)
    v = (w0 @ h0).astype(np.float32)
    v[0, 0] = 0.0  # exercise the zero floor
    params = SNMFParams(r=r, cf=cf, sparsity=0.1, max_iter=15,
                        init_w=w0, init_h=h0)
    single = sparse_nmf(v, params)
    sharded = sparse_nmf_sharded(v, params, make_mesh())
    np.testing.assert_allclose(sharded.w, single.w, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(sharded.cost, single.cost, rtol=2e-3)


def test_data_parallel_train_step(rng):
    """One DR-NMF train step with the batch sharded over 8 devices."""
    from drnmf_tpu.models import (
        DRNMFConfig, init_drnmf_params, drnmf_apply, drnmf_trainable_mask,
    )
    from drnmf_tpu.train import TrainConfig, make_optimizer, masked_mse_signal_approx
    from drnmf_tpu.train.loop import make_train_step

    f, r = 21, 4
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.2)
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(config, w)

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    opt = make_optimizer(TrainConfig(learning_rate=1e-3),
                         drnmf_trainable_mask(config, params))
    opt_state = opt.init(params)
    step = make_train_step(loss_fn, opt)

    mesh = make_mesh()
    x = rng.uniform(0, 2, (16, 8, f)).astype(np.float32)
    y = rng.uniform(0, 1, (16, 8, f)).astype(np.float32)
    mask = np.ones((16, 8, 1), np.float32)
    xb, yb, mb = shard_batch((x, y, mask), mesh)
    params_r = replicate_params(params, mesh)

    p2, _, loss_sharded = step(params_r, opt_state, xb, yb, mb)
    p2_ref, _, loss_single = step(params, opt.init(params), x, y, mask)
    assert abs(float(loss_sharded) - float(loss_single)) < 1e-5
    np.testing.assert_allclose(
        np.asarray(p2["log_D_0"]), np.asarray(p2_ref["log_D_0"]),
        rtol=1e-4, atol=1e-6,
    )


def test_dp_training_multi_epoch_matches_single_device(rng):
    """Multi-epoch data-parallel train_model == single-device train_model at
    equal global batch: same shuffles (same seed), gradients psum'd over the
    mesh, partial final batch padded with zero-mask rows."""
    from drnmf_tpu.models import (
        DRNMFConfig, init_drnmf_params, drnmf_apply, drnmf_trainable_mask,
    )
    from drnmf_tpu.train import (
        TrainConfig, train_model, masked_mse_signal_approx,
    )

    f, r = 9, 4
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.2,
                         params_untied=("log_D", "log_alph"),
                         params_trainable=("log_D", "log_alph"))
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(config, w)

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    n, t = 20, 10  # n=20, batch 16 -> final batch of 4 pads to 8 devices
    x = rng.uniform(0, 2, (n, t, f)).astype(np.float32)
    y = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    mask = np.ones((n, t, 1), np.float32)
    mask[3, 6:] = 0.0
    tc = TrainConfig(epochs=3, batch_size=16, learning_rate=1e-2,
                     patience=50, verbose=False)

    _, hist_1 = train_model(params, loss_fn, (x, y, mask), (x, y, mask), tc)
    mesh = make_mesh(8)
    best_dp, hist_dp = train_model(params, loss_fn, (x, y, mask),
                                   (x, y, mask), tc, mesh=mesh)

    l1 = hist_1.history["on_epoch_end"]
    ldp = hist_dp.history["on_epoch_end"]
    assert len(ldp["loss"]) == 3
    np.testing.assert_allclose(ldp["loss"], l1["loss"], rtol=1e-4)
    np.testing.assert_allclose(ldp["val_loss"], l1["val_loss"], rtol=1e-4)
    # training actually learned something
    assert ldp["loss"][-1] < ldp["loss"][0]


def test_seq_pipelined_scan_matches_single_device(rng):
    """Time-sharded pipelined recurrence == single-device lax.scan exactly
    (the wavefront pipeline reorders placement, not math)."""
    import numpy as np
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import (
        _scan_hidden,
        step_mask_from_input,
    )
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.seqpipe import drnmf_scan_seq_pipelined

    f, r, K = 9, 3, 2
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K)
    params = init_drnmf_params(config, w)

    bsz, t_total = 16, 40  # B div groups(8), T div sp(8)
    x = rng.uniform(0, 1, (bsz, t_total, f)).astype(np.float32)
    # mask out the tail of some sequences (state must hold across chunks)
    x[3, 25:, :] = config.mask_value
    x[7, 10:, :] = config.mask_value
    xj = jnp.asarray(x)
    step_mask = step_mask_from_input(xj, config.mask_value)

    ref = np.asarray(_scan_hidden(params, config, xj, step_mask))

    mesh = make_mesh(8, axis_name="sp")
    out = np.asarray(
        drnmf_scan_seq_pipelined(params, config, xj, step_mask, mesh)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_seq_pipelined_scan_group_count(rng):
    import numpy as np
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.seqpipe import drnmf_scan_seq_pipelined

    f, r = 5, 2
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=1)
    params = init_drnmf_params(config, w)
    x = jnp.asarray(rng.uniform(0, 1, (12, 16, f)).astype(np.float32))
    mask = step_mask_from_input(x, config.mask_value)
    ref = np.asarray(_scan_hidden(params, config, x, mask))
    mesh = make_mesh(8, axis_name="sp")
    out = np.asarray(
        drnmf_scan_seq_pipelined(params, config, x, mask, mesh, n_groups=4)
    )
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_seq_pipelined_scan_caches_across_param_values(rng):
    """The jitted shard_map is reused when only param VALUES change (params
    are program arguments, not closure constants) -- a recompile per call
    would cost more than the scan."""
    import numpy as np
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel import seqpipe

    f, r = 5, 2
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2)
    x = jnp.asarray(rng.uniform(0, 1, (8, 16, f)).astype(np.float32))
    mask = step_mask_from_input(x, config.mask_value)
    mesh = make_mesh(8, axis_name="sp")

    seqpipe._COMPILED.clear()
    for seed in (0, 1):
        w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
        w /= np.sqrt(np.sum(w**2, axis=0))
        params = init_drnmf_params(config, w)
        out = np.asarray(
            seqpipe.drnmf_scan_seq_pipelined(params, config, x, mask, mesh)
        )
        ref = np.asarray(_scan_hidden(params, config, x, mask))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert len(seqpipe._COMPILED) == 1


def test_tensor_parallel_scan_matches_single_device(rng):
    """Megatron-style hidden-dim sharding == single-device scan exactly."""
    import numpy as np
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.tensor_parallel import drnmf_scan_tp

    f, r, K = 9, 8, 3  # hidden 16 over 8-way tp
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)
    x = rng.uniform(0, 1, (3, 11, f)).astype(np.float32)
    x[1, 7:, :] = config.mask_value
    xj = jnp.asarray(x)
    sm = step_mask_from_input(xj, config.mask_value)

    ref = np.asarray(_scan_hidden(params, config, xj, sm))
    mesh = make_mesh(8, axis_name="tp")
    out = np.asarray(drnmf_scan_tp(params, config, xj, sm, mesh))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_tensor_parallel_rejects_indivisible(rng):
    import numpy as np
    import pytest
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.tensor_parallel import drnmf_scan_tp

    config = DRNMFConfig(input_dim=5, r=3, output_dim=5, K_layers=1)
    w = np.abs(np.random.default_rng(0).standard_normal((5, 6))).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(config, w)
    mesh = make_mesh(8, axis_name="tp")
    with pytest.raises(ValueError, match="not divisible"):
        drnmf_scan_tp(params, config, np.zeros((1, 2, 5), np.float32),
                      np.ones((1, 2), bool), mesh)


def test_tensor_parallel_train_scan_grad_parity(rng):
    """Differentiable TP formulation: forward AND gradients == single-device
    scan (psum decomposition; its transpose is replication)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.tensor_parallel import drnmf_scan_tp_train

    f, r, K = 9, 8, 2
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)
    x = jnp.asarray(rng.uniform(0, 1, (2, 6, f)).astype(np.float32))
    sm = step_mask_from_input(x, config.mask_value)
    mesh = make_mesh(8, axis_name="tp")

    ref = np.asarray(_scan_hidden(params, config, x, sm))
    out = np.asarray(drnmf_scan_tp_train(params, config, x, sm, mesh))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)

    g_tp = jax.grad(lambda p: jnp.mean(
        drnmf_scan_tp_train(p, config, x, sm, mesh) ** 2))(params)
    g_ref = jax.grad(lambda p: jnp.mean(
        _scan_hidden(p, config, x, sm) ** 2))(params)
    for k in g_ref:
        if k in ("log_U1", "log_Uk"):
            # frozen in this config: the folded single-device scan treats U
            # as a constant (exact-zero grads) while the dense TP scan
            # produces dead values -- both are masked by the optimizer
            np.testing.assert_allclose(np.asarray(g_ref[k]), 0.0)
            continue
        np.testing.assert_allclose(np.asarray(g_tp[k]), np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6)


def test_tensor_parallel_dense_u_branch(rng):
    """With trainable U the fold is disabled: both TP formulations take the
    dense row-sharded-U branch and still match the single-device scan
    (forward AND gradients, including real log_U1/log_Uk grads)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import (
        _scan_hidden, step_mask_from_input, u_is_foldable)
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.tensor_parallel import (
        drnmf_scan_tp, drnmf_scan_tp_train)

    f, r, K = 9, 8, 2
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         params_untied=("log_D", "log_alph"),
                         params_trainable=("log_D", "log_alph",
                                           "log_U1", "log_Uk"))
    assert not u_is_foldable(config)
    params = init_drnmf_params(config, w)
    # move U off its structured init so the dense path is actually exercised
    key = jax.random.PRNGKey(3)
    params["log_U1"] = params["log_U1"] + 0.01 * jax.random.normal(
        key, params["log_U1"].shape)
    x = jnp.asarray(rng.uniform(0, 1, (2, 6, f)).astype(np.float32))
    sm = step_mask_from_input(x, config.mask_value)
    mesh = make_mesh(8, axis_name="tp")

    ref = np.asarray(_scan_hidden(params, config, x, sm))
    out = np.asarray(drnmf_scan_tp(params, config, x, sm, mesh))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    out_t = np.asarray(drnmf_scan_tp_train(params, config, x, sm, mesh))
    np.testing.assert_allclose(out_t, ref, rtol=1e-5, atol=1e-6)

    g_tp = jax.grad(lambda p: jnp.mean(
        drnmf_scan_tp_train(p, config, x, sm, mesh) ** 2))(params)
    g_ref = jax.grad(lambda p: jnp.mean(
        _scan_hidden(p, config, x, sm) ** 2))(params)
    assert float(np.abs(np.asarray(g_ref["log_U1"])).max()) > 0
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g_tp[k]), np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6)


def test_tp_dp_2d_forward_and_grad_parity(rng):
    """Combined 2-D dp x tp mesh (4x2 over the 8 virtual devices): the full
    forward (recurrence + heads + ratio mask) and the gradients of a
    masked training loss match the single-device model exactly -- the
    production sharding (batch over dp, contraction over tp)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import drnmf_forward, step_mask_from_input
    from drnmf_tpu.parallel import drnmf_apply_tp_dp, make_mesh_2d
    from drnmf_tpu.train import masked_mse_signal_approx

    f, r, K = 9, 4, 3  # hidden 8 over 2-way tp
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)
    x = rng.uniform(0, 1, (8, 7, f)).astype(np.float32)
    x[2, 5:, :] = config.mask_value  # ragged batch: masked tail
    xj = jnp.asarray(x)
    sm = step_mask_from_input(xj, config.mask_value)
    y = jnp.asarray(rng.uniform(0, 1, x.shape).astype(np.float32))
    m = np.ones((8, 7, 1), np.float32)
    m[2, 5:] = 0.0
    m = jnp.asarray(m)

    mesh = make_mesh_2d(4, 2)
    assert dict(mesh.shape) == {"dp": 4, "tp": 2}

    irm_ref = np.asarray(drnmf_forward(params, config, xj))
    irm_2d = np.asarray(drnmf_apply_tp_dp(params, config, xj, sm, mesh))
    np.testing.assert_allclose(irm_2d, irm_ref, rtol=1e-5, atol=1e-6)

    def loss_2d(p):
        irm = drnmf_apply_tp_dp(p, config, xj, sm, mesh)
        return masked_mse_signal_approx(irm, xj, y, m)

    def loss_ref(p):
        return masked_mse_signal_approx(drnmf_forward(p, config, xj), xj, y, m)

    l2d, g_2d = jax.value_and_grad(loss_2d)(params)
    lrf, g_ref = jax.value_and_grad(loss_ref)(params)
    np.testing.assert_allclose(float(l2d), float(lrf), rtol=1e-6)
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g_2d[k]), np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_fsdp_param_sharding_rule():
    """FSDP placement (parallel.mesh.fsdp_param_sharding): the LARGEST
    dp-divisible dimension shards over 'dp'; arrays below the size floor or
    with no divisible dimension replicate; a sharded param's addressable
    shard is 1/dp of the full array."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from drnmf_tpu.parallel import fsdp_param_sharding

    mesh = make_mesh(8)
    big = jnp.zeros((16, 24), jnp.float32)
    s = fsdp_param_sharding(big, mesh, min_elems=64)
    assert s.spec == P(None, "dp")  # 24 > 16: largest divisible dim
    placed = jax.device_put(big, s)
    assert placed.addressable_shards[0].data.shape == (16, 3)
    # below the size floor -> replicated
    assert fsdp_param_sharding(big, mesh, min_elems=1 << 16).spec == P()
    # no dp-divisible dimension -> replicated
    assert fsdp_param_sharding(
        jnp.zeros((9, 13), jnp.float32), mesh, min_elems=1).spec == P()


def test_fsdp_training_matches_replicated_dp(rng):
    """ZeRO-3 layout == replicated layout, trajectory for trajectory: params
    and Adam moments sharded over dp (fsdp=True) produce the same per-epoch
    losses and the same best params as replicated data-parallel training
    (the all-gather/reduce-scatter decomposition is the same sum)."""
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params, drnmf_apply
    from drnmf_tpu.train import (
        TrainConfig, train_model, masked_mse_signal_approx,
    )

    f, r = 9, 4  # hidden_dim 2r=8 divides the 8-device mesh; F=9 does not
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.2,
                         params_untied=("log_D", "log_alph"),
                         params_trainable=("log_D", "log_alph"))
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(config, w)

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    n, t = 20, 10
    x = rng.uniform(0, 2, (n, t, f)).astype(np.float32)
    y = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    mask = np.ones((n, t, 1), np.float32)
    tc = TrainConfig(epochs=3, batch_size=16, learning_rate=1e-2,
                     patience=50, verbose=False)

    mesh = make_mesh(8)
    best_rep, hist_rep = train_model(params, loss_fn, (x, y, mask),
                                     (x, y, mask), tc, mesh=mesh)
    best_fs, hist_fs = train_model(params, loss_fn, (x, y, mask),
                                   (x, y, mask), tc, mesh=mesh,
                                   fsdp=True, fsdp_min_elems=8)

    lr = hist_rep.history["on_epoch_end"]
    lf = hist_fs.history["on_epoch_end"]
    np.testing.assert_allclose(lf["loss"], lr["loss"], rtol=1e-4)
    np.testing.assert_allclose(lf["val_loss"], lr["val_loss"], rtol=1e-4)
    for k in best_rep:
        np.testing.assert_allclose(np.asarray(best_fs[k]),
                                   np.asarray(best_rep[k]),
                                   rtol=1e-4, atol=1e-6)


def test_fsdp_resume_continues_exactly(rng, tmp_path):
    """Elastic resume under the FSDP layout: params and optimizer moments
    are re-placed with their dp shardings at load, and the interrupted-and
    -resumed run equals the uninterrupted one."""
    import jax.numpy as jnp
    from drnmf_tpu.train import TrainConfig, train_model

    n, t, f = 12, 6, 8  # f=8 divides the mesh -> w/b shard over dp
    x = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    y = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    mask = np.ones((n, t), np.float32)
    params0 = {"w": jnp.zeros((f, f), jnp.float32),
               "b": jnp.zeros((f,), jnp.float32)}

    def loss_fn(p, xb, yb, mb):
        pred = xb @ p["w"] + p["b"]
        return jnp.mean((pred - yb) ** 2)

    mesh = make_mesh(8)

    def run(save, epochs):
        return train_model(
            dict(params0), loss_fn, (x, y, mask), (x, y, mask),
            TrainConfig(epochs=epochs, batch_size=4, learning_rate=1e-2,
                        verbose=False),
            savefile=save, resume=True, mesh=mesh,
            fsdp=True, fsdp_min_elems=8,
        )

    full, _ = run(str(tmp_path / "full.npz"), 6)
    run(str(tmp_path / "part.npz"), 3)
    assert (tmp_path / "part.npz.train_state").exists()
    resumed, _ = run(str(tmp_path / "part.npz"), 6)

    for k in full:
        np.testing.assert_allclose(np.asarray(resumed[k]),
                                   np.asarray(full[k]),
                                   rtol=1e-6, atol=1e-7)


def test_fsdp_with_rng_loss(rng, tmp_path):
    """FSDP composes with an rng-threaded training loss (variational
    dropout path: loss_takes_rng=True); eval stays rng-free."""
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.train import TrainConfig, train_model

    n, t, f = 8, 5, 8
    x = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    y = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    mask = np.ones((n, t), np.float32)
    params0 = {"w": jnp.zeros((f, f), jnp.float32)}

    def train_loss(p, xb, yb, mb, key):
        drop = jax.random.bernoulli(key, 0.8, xb.shape).astype(xb.dtype)
        pred = (xb * drop) @ p["w"]
        return jnp.mean((pred - yb) ** 2)

    def eval_loss(p, xb, yb, mb):
        return jnp.mean((xb @ p["w"] - yb) ** 2)

    best, hist = train_model(
        params0, train_loss, (x, y, mask), (x, y, mask),
        TrainConfig(epochs=2, batch_size=4, learning_rate=1e-2,
                    verbose=False),
        mesh=make_mesh(8), fsdp=True, fsdp_min_elems=8,
        eval_loss_fn=eval_loss, loss_takes_rng=True,
    )
    assert np.all(np.isfinite(hist.history["on_epoch_end"]["loss"]))
    assert np.all(np.isfinite(np.asarray(best["w"])))


@pytest.mark.parametrize("kw", [
    dict(),                                       # folded U + factored S
    dict(params_trainable=("log_D", "log_alph", "log_U1", "log_Uk")),
])
def test_layer_pipelined_scan_matches_single_device(rng, kw):
    """Layer-sharded (pp) pipelined recurrence == single-device lax.scan:
    device p runs only layer p, activations hand forward over the ring,
    layer K-1's masked-held state rides the ring back as the next step's
    U-term source. Covers the folded-U/factored-S fast path and (via
    trainable U, which disables the fold) the dense-U path."""
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.layerpipe import drnmf_scan_layer_pipelined
    import jax.numpy as jnp

    f, r, K = 9, 3, 4
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K, **kw)
    params = init_drnmf_params(config, w)
    # make U structurally non-trivial when dense so the test is sharp
    if "params_trainable" in kw:
        params = dict(params)
        params["log_U1"] = jnp.asarray(
            rng.uniform(-3, 0, (2 * r, 2 * r)).astype(np.float32))
        params["log_Uk"] = jnp.asarray(
            rng.uniform(-6, -3, (2 * r, 2 * r)).astype(np.float32))

    bsz, t_total = 8, 7  # B div pp(4); T arbitrary
    x = rng.uniform(0, 1, (bsz, t_total, f)).astype(np.float32)
    x[3, 5:, :] = config.mask_value  # held state must survive the ring
    x[6, 2:, :] = config.mask_value
    xj = jnp.asarray(x)
    step_mask = step_mask_from_input(xj, config.mask_value)

    ref = np.asarray(_scan_hidden(params, config, xj, step_mask))
    mesh = make_mesh(4, axis_name="pp")
    out = np.asarray(
        drnmf_scan_layer_pipelined(params, config, xj, step_mask, mesh))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_layer_pipelined_rejects_mismatched_k(rng):
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.layerpipe import drnmf_scan_layer_pipelined
    import jax.numpy as jnp

    f, r = 9, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2)
    params = init_drnmf_params(config, w)
    x = jnp.zeros((8, 4, f), jnp.float32)
    sm = step_mask_from_input(x, config.mask_value)
    with pytest.raises(ValueError, match="must equal the pp axis"):
        drnmf_scan_layer_pipelined(params, config, x, sm,
                                   make_mesh(4, axis_name="pp"))


def test_layer_pipelined_rejects_k1(rng):
    """K=1 (pp axis of 1) is a degenerate pipeline and the dense-S branch
    would trace an unbound S stack (advisor r3 finding) -- rejected with
    a clear error instead."""
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.layerpipe import drnmf_scan_layer_pipelined
    import jax.numpy as jnp

    f, r = 9, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=1)
    params = init_drnmf_params(config, w)
    x = jnp.zeros((2, 4, f), jnp.float32)
    sm = step_mask_from_input(x, config.mask_value)
    with pytest.raises(ValueError, match="K_layers >= 2"):
        drnmf_scan_layer_pipelined(params, config, x, sm,
                                   make_mesh(1, axis_name="pp"))


def test_layer_pipelined_grad_parity(rng):
    """Gradients THROUGH the layer pipeline equal the single-device scan's
    (ppermute transposes to the reverse ring; the wave fori_loop has a
    static trip count)."""
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.parallel.layerpipe import drnmf_scan_layer_pipelined

    f, r, K = 9, 3, 4
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K)
    params = init_drnmf_params(config, w)
    x = jnp.asarray(rng.uniform(0, 1, (8, 6, f)).astype(np.float32))
    sm = step_mask_from_input(x, config.mask_value)
    mesh = make_mesh(4, axis_name="pp")

    g_pp = jax.grad(lambda p: jnp.mean(
        drnmf_scan_layer_pipelined(p, config, x, sm, mesh) ** 2))(params)
    g_1 = jax.grad(lambda p: jnp.mean(
        _scan_hidden(p, config, x, sm) ** 2))(params)
    for k in g_1:
        np.testing.assert_allclose(np.asarray(g_pp[k]), np.asarray(g_1[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

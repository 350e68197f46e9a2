"""DR-NMF model tests.

Key oracle: the plain-numpy transcription of the reference cell semantics
in drnmf_tpu/reference.py (custom_layers.py:343-375 step + enhance.py:139-206
parameter maps, dense U and S), and the
relationship that layers k>=2 of the unfolded cell at initialization perform
*exact* ISTA steps (enhance.py:402-418) under the SNMF dictionary.
"""

import numpy as np
import pytest

from drnmf_tpu.models import (
    DRNMFConfig,
    init_drnmf_params,
    drnmf_apply,
    drnmf_trainable_mask,
)
from drnmf_tpu.reference import numpy_forward

EPS = 1e-7


def make_dict(rng, f, r2):
    w = rng.uniform(0.05, 1.0, (f, r2)).astype(np.float32)
    return w / np.sqrt(np.sum(w**2, axis=0))


@pytest.mark.parametrize("untied", [(), ("log_D", "log_alph")])
def test_forward_matches_numpy_transcription(rng, untied):
    f, r, K, T = 33, 8, 3, 12
    config = DRNMFConfig(
        input_dim=f, r=r, output_dim=f, K_layers=K, alph=10.0, lam1=0.5,
        params_untied=untied, params_trainable=untied or ("log_D",),
    )
    w = make_dict(rng, f, 2 * r)
    params = init_drnmf_params(config, w)
    x = rng.uniform(0.0, 2.0, (1, T, f)).astype(np.float32)

    irm_jax, hidden_jax, _, _ = drnmf_apply(params, config, x, return_parts=True)
    hs_ref, irm_ref = numpy_forward(params, config, x[0])
    np.testing.assert_allclose(np.asarray(hidden_jax)[0], hs_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(irm_jax)[0], irm_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("K", [1, 2, 3, 5])
def test_reference_forward_matches_drnmf_apply(rng, K):
    """The production path (frozen-U fold, factored S) over a batch equals
    the dense float64 reference for every depth, K=5 being the flagship's."""
    f, r, T = 33, 8, 10
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.5)
    params = init_drnmf_params(config, make_dict(rng, f, 2 * r))
    x = rng.uniform(0.0, 2.0, (3, T, f)).astype(np.float32)
    irm, hidden, _, _ = drnmf_apply(params, config, x, return_parts=True)
    hs_ref, irm_ref = numpy_forward(params, config, x)
    assert hs_ref.shape == (3, T, 2 * r) and irm_ref.shape == (3, T, f)
    np.testing.assert_allclose(np.asarray(hidden), hs_ref, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(irm), irm_ref, rtol=1e-4,
                               atol=1e-5)


def test_layers_after_first_are_exact_ista_steps(rng):
    """At init, layer k>=2 computes one exact ISTA/ED step from layer k-1's
    state (the mathematical content of 'unfolded SNMF')."""
    f, r, K = 21, 6, 4
    alph, lam1 = 15.0, 0.7
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=alph, lam1=lam1, params_untied=())
    w = make_dict(rng, f, 2 * r)
    params = {k: np.asarray(v, np.float64) for k, v in init_drnmf_params(config, w).items()}

    d = np.exp(params["log_D"])
    dhat = d / np.sqrt(np.sum(d**2, axis=0, keepdims=True))
    a = np.exp(params["log_alph"])
    l1 = np.exp(params["log_lam1"])
    x = rng.uniform(0.0, 2.0, (f,))
    h_prev = np.abs(rng.standard_normal(2 * r))

    # layer 1 (SISTA-RNN form): relu(h_prev @ U1 + x @ D/a - l1/a)
    u1 = np.exp(params["log_U1"]).T
    hidden = np.maximum(0, h_prev @ u1 + x @ (dhat / a) - l1 / a)
    # layers 2..K must be exact ISTA steps
    s = (np.eye(2 * r) - (dhat / a).T @ dhat).T
    for k in range(1, K):
        uk = np.exp(params["log_Uk"]).T
        cell_next = np.maximum(0, h_prev @ uk + hidden @ s + x @ (dhat / a) - l1 / a)
        ista_next = np.maximum(
            0, -l1 / a + hidden + (1.0 / a) * dhat.T @ (x - dhat @ hidden)
        )
        # the only difference is the ~1e-7 U_k and off-diagonal U1 leakage
        np.testing.assert_allclose(cell_next, ista_next, rtol=1e-4, atol=1e-4)
        hidden = cell_next


def test_mask_holds_state(rng):
    """Masked (all == mask_value) timesteps must carry state through
    unchanged (Keras Masking + Recurrent semantics)."""
    f, r = 17, 4
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=5.0, lam1=0.1, params_untied=())
    w = make_dict(rng, f, 2 * r)
    params = init_drnmf_params(config, w)

    x_valid = rng.uniform(0.0, 2.0, (1, 6, f)).astype(np.float32)
    pad = -np.ones((1, 4, f), np.float32)
    x_padded = np.concatenate([x_valid, pad], axis=1)

    _, hid_short, _, _ = drnmf_apply(params, config, x_valid, return_parts=True)
    _, hid_long, _, _ = drnmf_apply(params, config, x_padded, return_parts=True)
    np.testing.assert_allclose(
        np.asarray(hid_long)[0, :6], np.asarray(hid_short)[0], rtol=1e-5, atol=1e-6
    )
    # held state equals last valid state
    held = np.asarray(hid_long)[0, 6:]
    np.testing.assert_allclose(
        held,
        np.broadcast_to(np.asarray(hid_long)[0, 5], held.shape),
        rtol=1e-5,
        atol=1e-6,
    )


def test_irm_range_and_shapes(rng):
    f, r = 17, 4
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=5.0, lam1=0.1)
    w = make_dict(rng, f, 2 * r)
    params = init_drnmf_params(config, w)
    x = rng.uniform(0.0, 2.0, (3, 9, f)).astype(np.float32)
    irm = np.asarray(drnmf_apply(params, config, x))
    assert irm.shape == (3, 9, f)
    assert np.all(irm >= 0) and np.all(irm <= 1.0 + 1e-6)


def test_trainable_mask(rng):
    config = DRNMFConfig(input_dim=9, r=3, output_dim=9, K_layers=2,
                         params_untied=("log_D", "log_alph"),
                         params_trainable=("log_D", "log_alph"))
    w = make_dict(rng, 9, 6)
    params = init_drnmf_params(config, w)
    mask = drnmf_trainable_mask(config, params)
    assert mask["log_D_0"] and mask["log_D_1"]
    assert mask["log_alph_0"] and mask["log_alph_1"]
    assert mask["log_h0"] and mask["log_W_clean"] and mask["log_W_noise"]
    assert not mask["log_U1"] and not mask["log_Uk"] and not mask["log_lam1"]


def test_square_transform(rng):
    f, r = 9, 3
    w = make_dict(rng, f, 2 * r)
    x = rng.uniform(0.0, 2.0, (1, 5, f)).astype(np.float32)
    cfg_plain = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2)
    cfg_sq = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         transform_before_irm="square")
    params = init_drnmf_params(cfg_plain, w)
    irm_plain = np.asarray(drnmf_apply(params, cfg_plain, x))
    irm_sq = np.asarray(drnmf_apply(params, cfg_sq, x))
    assert not np.allclose(irm_plain, irm_sq)
    _, _, c, n = drnmf_apply(params, cfg_sq, x, return_parts=True)
    expect = np.square(np.asarray(c)) / (
        1e-7 + np.square(np.asarray(c)) + np.square(np.asarray(n))
    )
    np.testing.assert_allclose(irm_sq, expect, rtol=1e-4, atol=1e-5)


def test_lstm_forward_and_masking(rng):
    from drnmf_tpu.models import LSTMConfig, init_lstm_params, lstm_apply

    config = LSTMConfig(input_dim=17, hidden_dim=12, output_dim=17, K_layers=2)
    params = init_lstm_params(config)
    x = rng.uniform(0.0, 2.0, (2, 7, 17)).astype(np.float32)
    m = np.asarray(lstm_apply(params, config, x))
    assert m.shape == (2, 7, 17)
    assert np.all(m > 0) and np.all(m < 1)

    pad = -np.ones((2, 3, 17), np.float32)
    m_long = np.asarray(lstm_apply(params, config, np.concatenate([x, pad], 1)))
    np.testing.assert_allclose(m_long[:, :7], m, rtol=1e-5, atol=1e-6)


def test_snmf_enhancer_mask(rng):
    from drnmf_tpu.models import snmf_infer_irm
    from drnmf_tpu.ops import SNMFParams

    f, r, n = 16, 4, 60
    w = make_dict(rng, f, 2 * r)
    h_true = np.abs(rng.standard_normal((2 * r, n))).astype(np.float32)
    x = (w @ h_true).astype(np.float32)
    params = SNMFParams(r=r, cf="ed", sparsity=0.1, max_iter=100)
    irm, h = snmf_infer_irm(x, w, params, max_iter=100)
    assert irm.shape == (f, n)
    assert np.all(irm >= 0) and np.all(irm <= 1)
    assert h.shape == (2 * r, n)


# ---------------------------------------------------------------------------
# cell capability flags (SimpleDeepRNN parity: custom_layers.py:131-168)
# ---------------------------------------------------------------------------

def test_return_all_hidden(rng):
    import jax
    f, r, K = 9, 3, 3
    w = make_dict(rng, f, 2 * r)
    x = rng.uniform(0, 1, (2, 7, f)).astype(np.float32)
    base = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K)
    allh = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                       return_all_hidden=True)
    p = init_drnmf_params(base, w)
    _, hid_base, ce, ne = drnmf_apply(p, base, x, return_parts=True)
    _, hid_all, ce2, ne2 = drnmf_apply(p, allh, x, return_parts=True)
    assert hid_all.shape == (2, 7, K * 2 * r)
    # last block == the default top-layer hidden; heads identical
    np.testing.assert_allclose(np.asarray(hid_all[..., -2 * r:]),
                               np.asarray(hid_base), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ce2), np.asarray(ce),
                               rtol=1e-5, atol=1e-6)


def test_connect_input_to_layers_off(rng):
    f, r = 9, 3
    w = make_dict(rng, f, 2 * r)
    x = rng.uniform(0.2, 1, (2, 5, f)).astype(np.float32)
    on = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2)
    off = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                      connect_input_to_layers=False)
    p = init_drnmf_params(on, w)
    irm_on = np.asarray(drnmf_apply(p, on, x))
    irm_off = np.asarray(drnmf_apply(p, off, x))
    assert not np.allclose(irm_on, irm_off)


def test_activation_flag(rng):
    f, r = 9, 3
    w = make_dict(rng, f, 2 * r)
    x = rng.uniform(0.2, 1, (2, 5, f)).astype(np.float32)
    for act in ("tanh", "sigmoid", "linear"):
        cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                          activation=act)
        p = init_drnmf_params(cfg, w)
        _, hid, _, _ = drnmf_apply(p, cfg, x, return_parts=True)
        hid = np.asarray(hid)
        assert np.all(np.isfinite(hid))
        if act == "sigmoid":
            assert np.all((hid >= 0) & (hid <= 1))
        if act == "tanh":
            assert np.all((hid >= -1) & (hid <= 1))
        if act == "linear":
            assert np.any(hid < 0) or np.any(hid > 0)


def test_nonnegative_off_plain_h0(rng):
    f, r = 9, 3
    w = make_dict(rng, f, 2 * r)
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                      nonnegative=False)
    p = init_drnmf_params(cfg, w)
    assert "h0" in p and "log_h0" not in p
    np.testing.assert_array_equal(np.asarray(p["h0"]), 0.0)
    mask = drnmf_trainable_mask(cfg, p)
    assert mask["h0"]
    x = rng.uniform(0.2, 1, (2, 5, f)).astype(np.float32)
    assert np.all(np.isfinite(np.asarray(drnmf_apply(p, cfg, x))))


def test_variational_dropout(rng):
    import jax
    f, r = 9, 3
    w = make_dict(rng, f, 2 * r)
    x = rng.uniform(0.2, 1, (4, 6, f)).astype(np.float32)
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                      dropout_W=0.5, dropout_U=0.5)
    p = init_drnmf_params(cfg, w)
    k1, k2 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
    a = np.asarray(drnmf_apply(p, cfg, x, rng=k1, training=True))
    a2 = np.asarray(drnmf_apply(p, cfg, x, rng=k1, training=True))
    b = np.asarray(drnmf_apply(p, cfg, x, rng=k2, training=True))
    np.testing.assert_array_equal(a, a2)  # deterministic per rng
    assert not np.allclose(a, b)  # different masks differ
    # eval mode ignores dropout entirely (Keras in_train_phase)
    ev = np.asarray(drnmf_apply(p, cfg, x))
    plain = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2)
    np.testing.assert_allclose(
        ev, np.asarray(drnmf_apply(p, plain, x)), rtol=1e-6
    )
    # training without an rng is a clear error
    with pytest.raises(ValueError, match="rng"):
        drnmf_apply(p, cfg, x, training=True)


def test_remat_gradients_match(rng):
    """jax.checkpoint'd scan step (both rematerialization policies):
    identical loss and gradients to the un-checkpointed backward."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    f, r = 9, 3
    w = make_dict(rng, f, 2 * r)
    x = jnp.asarray(rng.uniform(0.2, 1, (2, 12, f)).astype(np.float32))
    y = jnp.asarray(rng.uniform(0, 1, (2, 12, f)).astype(np.float32))
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                      remat=False)

    def loss(p, cfg):
        irm = drnmf_apply(p, cfg, x)
        return jnp.mean((irm * x - y) ** 2)

    p = init_drnmf_params(cfg, w)
    l0, g0 = jax.value_and_grad(lambda p: loss(p, cfg))(p)
    for policy in ("full", "dots", "none", "auto"):
        cfg_r = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        l1, g1 = jax.value_and_grad(lambda p: loss(p, cfg_r))(p)
        assert float(l0) == float(l1), policy
        for k in g0:
            np.testing.assert_allclose(
                np.asarray(g0[k]), np.asarray(g1[k]),
                rtol=1e-6, atol=1e-7, err_msg=f"{policy}:{k}")
    with pytest.raises(ValueError, match="remat_policy"):
        bad = dataclasses.replace(cfg, remat=True, remat_policy="nope")
        jax.value_and_grad(lambda p: loss(p, bad))(p)


def test_remat_auto_resolution(monkeypatch):
    """'auto' picks store-all when the closed-form residual bound fits the
    budget and falls back to full remat when it does not; explicit
    policies pass through untouched."""
    from drnmf_tpu.models.drnmf import (
        resolve_remat_policy, scan_residual_bytes)

    cfg = DRNMFConfig(input_dim=257, r=1000, output_dim=257, K_layers=5)
    # flagship parity shape: the bound is ~2.3 GB -- under the 4 GB default
    bound = scan_residual_bytes(cfg, 32, 500)
    assert 1e9 < bound < 4e9
    assert resolve_remat_policy(cfg, 32, 500) == "none"
    # a shape past the budget (10x the batch) falls back to full remat
    assert resolve_remat_policy(cfg, 320, 500) == "full"
    # the budget is an env knob
    monkeypatch.setenv("DRNMF_REMAT_AUTO_BUDGET_BYTES", "1")
    assert resolve_remat_policy(cfg, 2, 4) == "full"
    monkeypatch.delenv("DRNMF_REMAT_AUTO_BUDGET_BYTES")
    for explicit in ("none", "full", "dots"):
        import dataclasses
        cfg_e = dataclasses.replace(cfg, remat_policy=explicit)
        assert resolve_remat_policy(cfg_e, 32, 500) == explicit


def test_frozen_u_fold_matches_dense(rng):
    """fold_frozen_U: with log_U1/log_Uk frozen at init (every shipped
    reference config, data_setup_downsample1/configs/*.yaml:10), the K
    per-step U matmuls collapse to an exact rank-one form.  Parity is
    checked under matmul_precision='highest' (f32-exact dense baseline;
    under 'default' the DENSE path carries reduced-precision matmul noise
    that the folded path does not)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models.drnmf import (
        _scan_hidden, step_mask_from_input, u_is_foldable)

    f, r, K = 11, 5, 3
    w = make_dict(rng, f, 2 * r)
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                      alph=10.0, lam1=0.5,
                      params_untied=("log_D", "log_alph"),
                      params_trainable=("log_D", "log_alph"),
                      matmul_precision="highest")
    assert u_is_foldable(cfg)
    cfg_dense = dataclasses.replace(cfg, fold_frozen_U=False)
    p = init_drnmf_params(cfg, w)
    x = rng.uniform(0, 2, (3, 25, f)).astype(np.float32)
    x[1, 18:] = cfg.mask_value  # masked tail holds state in both paths
    sm = step_mask_from_input(jnp.asarray(x), cfg.mask_value)

    h_fold = _scan_hidden(p, cfg, jnp.asarray(x), sm)
    h_dense = _scan_hidden(p, cfg_dense, jnp.asarray(x), sm)
    np.testing.assert_allclose(np.asarray(h_fold), np.asarray(h_dense),
                               rtol=1e-5, atol=1e-6)

    # gradients of the params the optimizer trains are identical; the
    # frozen U params get exact zeros from the folded path (stop_gradient)
    def loss(p, cfg):
        hs = _scan_hidden(p, cfg, jnp.asarray(x), sm)
        return jnp.mean(hs ** 2)

    g_fold = jax.grad(lambda p: loss(p, cfg))(p)
    g_dense = jax.grad(lambda p: loss(p, cfg_dense))(p)
    for k in g_dense:
        if k in ("log_U1", "log_Uk"):
            np.testing.assert_allclose(np.asarray(g_fold[k]), 0.0)
            continue
        np.testing.assert_allclose(np.asarray(g_fold[k]),
                                   np.asarray(g_dense[k]),
                                   rtol=1e-4, atol=1e-6)

    # trainable U disables the fold entirely (bitwise-identical dense path)
    cfg_t = dataclasses.replace(cfg, params_trainable=(
        "log_D", "log_alph", "log_U1", "log_Uk"))
    assert not u_is_foldable(cfg_t)
    h_t = _scan_hidden(p, cfg_t, jnp.asarray(x), sm)
    assert np.array_equal(np.asarray(h_t), np.asarray(h_dense))


def test_factored_s_matches_dense(rng):
    """factored_S: S_k = I - Dhat^T (Dhat/alph) applied as two thin
    F-contraction matmuls == the dense materialized (2r, 2r) matmul, for
    scalar and vector (untie_alph) alpha, forward and gradients.  Checked
    under matmul_precision='highest' (f32-exact dense baseline)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input

    f, r, K = 11, 8, 3
    w = make_dict(rng, f, 2 * r)
    x = rng.uniform(0, 2, (3, 20, f)).astype(np.float32)
    x[1, 15:] = -1.0
    for untie in (False, True):
        cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                          alph=10.0, lam1=0.5, untie_alph=untie,
                          params_untied=("log_D", "log_alph"),
                          params_trainable=("log_D", "log_alph"),
                          matmul_precision="highest")
        cfg_dense = dataclasses.replace(cfg, factored_S=False)
        p = init_drnmf_params(cfg, w)
        sm = step_mask_from_input(jnp.asarray(x), cfg.mask_value)
        h_f = _scan_hidden(p, cfg, jnp.asarray(x), sm)
        h_d = _scan_hidden(p, cfg_dense, jnp.asarray(x), sm)
        # pure reassociation of the same math; the relu recurrence amplifies
        # fp-level per-step deltas, so the tolerance is loose in absolute
        # terms but the END-TO-END effect is pinned on-chip: mean SDR delta
        # -0.0004 dB, worst per-file 0.006 dB (DESIGN 2c)
        np.testing.assert_allclose(np.asarray(h_f), np.asarray(h_d),
                                   rtol=1e-3, atol=1e-3)

        g_f = jax.grad(lambda p: jnp.mean(
            _scan_hidden(p, cfg, jnp.asarray(x), sm) ** 2))(p)
        g_d = jax.grad(lambda p: jnp.mean(
            _scan_hidden(p, cfg_dense, jnp.asarray(x), sm) ** 2))(p)
        for k in g_d:
            np.testing.assert_allclose(np.asarray(g_f[k]), np.asarray(g_d[k]),
                                       rtol=1e-2, atol=1e-3)


def test_ensure_fold_valid_detects_unstructured_u(rng):
    """A checkpoint whose frozen U deviates from the structured init must
    not run the rank-one fold (ADVICE r2): ensure_fold_valid disables it,
    and the resulting forward matches the exact dense-U computation."""
    from drnmf_tpu.models.drnmf import (
        ensure_fold_valid, fold_structure_holds, drnmf_forward)
    import dataclasses
    import jax.numpy as jnp

    f, r = 9, 4
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.2,
                         params_untied=("log_D", "log_alph"),
                         params_trainable=("log_D", "log_alph"))
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(config, w)

    # pristine init: structure holds, fold stays on
    assert fold_structure_holds(params)
    assert ensure_fold_valid(config, params, verbose=False) is config

    # perturb one off-diagonal of log_U1 (e.g. a checkpoint from a stage
    # where U trained): the fold must be disabled
    bad = {k: np.array(v, copy=True) for k, v in params.items()}
    bad["log_U1"][0, 2] += 0.5
    assert not fold_structure_holds(bad)
    cfg2 = ensure_fold_valid(config, bad, verbose=False)
    assert not cfg2.fold_frozen_U

    # and the guarded config computes the exact dense-U forward
    x = rng.uniform(0, 2, (2, 5, f)).astype(np.float32)
    got = np.asarray(drnmf_forward(bad, cfg2, jnp.asarray(x)))
    dense_cfg = dataclasses.replace(config, fold_frozen_U=False,
                                    factored_S=False)
    want = np.asarray(drnmf_forward(bad, dense_cfg, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)

    # perturbing log_Uk is caught too
    bad2 = {k: np.array(v, copy=True) for k, v in params.items()}
    bad2["log_Uk"][1, 1] += 0.3
    assert not fold_structure_holds(bad2)


def test_scan_unroll_is_exact(rng):
    """scan_unroll replicates the lax.scan body (scheduling only): hidden
    states and gradients are bit-identical at any unroll factor,
    including T not divisible by it."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input

    f, r, K = 9, 3, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K)
    params = init_drnmf_params(config, w)
    x = jnp.asarray(rng.uniform(0, 1, (4, 11, f)).astype(np.float32))
    sm = step_mask_from_input(x, config.mask_value)

    base = np.asarray(_scan_hidden(params, config, x, sm))
    g_base = jax.grad(lambda p: jnp.mean(
        _scan_hidden(p, config, x, sm) ** 2))(params)
    for u in (2, 4, 8):
        cfg = dataclasses.replace(config, scan_unroll=u)
        out = np.asarray(_scan_hidden(params, cfg, x, sm))
        np.testing.assert_array_equal(out, base, err_msg=f"unroll={u}")
        g = jax.grad(lambda p: jnp.mean(
            _scan_hidden(p, cfg, x, sm) ** 2))(params)
        for k in g_base:
            np.testing.assert_allclose(
                np.asarray(g[k]), np.asarray(g_base[k]), rtol=1e-6,
                atol=1e-7, err_msg=f"unroll={u} grad {k}")


@pytest.mark.parametrize("K", [1, 3])
def test_batched_grad_matches_autodiff(rng, K):
    """The batched-T backward (models/batched_grad.py custom VJP --
    sequential delta chain + one T*B-contraction matmul per weight
    gradient) produces the same forward values and the same gradients as
    autodiff through the standard scan, on the production configuration
    (relu, connect_input, frozen-U fold + factored S), including padded
    (masked) timesteps and grads w.r.t. the input."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from drnmf_tpu.models import init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input

    f, r = 9, 4
    base = DRNMFConfig(
        input_dim=f, r=r, output_dim=f, K_layers=K, alph=10.0, lam1=0.5,
        params_untied=("log_D", "log_alph"),
        params_trainable=("log_D", "log_alph"), scan_unroll=2,
    )
    cfg_b = dataclasses.replace(base, batched_grad=True)
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(base, w)

    bsz, t = 3, 7
    x = rng.uniform(0.0, 2.0, (bsz, t, f)).astype(np.float32)
    x[1, 5:] = base.mask_value  # padded tail
    x[2, 3:] = base.mask_value
    xj = jnp.asarray(x)
    sm = step_mask_from_input(xj, base.mask_value)

    hs_a = _scan_hidden(params, base, xj, sm)
    hs_b = _scan_hidden(params, cfg_b, xj, sm)
    np.testing.assert_allclose(np.asarray(hs_b), np.asarray(hs_a),
                               rtol=1e-6, atol=1e-7)

    def loss(cfg):
        def f_(p, xx):
            hs = _scan_hidden(p, cfg, xx, sm)
            return jnp.mean(jnp.where(sm[..., None], hs, 0.0) ** 2) \
                + jnp.sum(hs[:, -1] ** 3) * 1e-3
        return f_

    g_a = jax.jit(jax.grad(loss(base), argnums=(0, 1)))(params, xj)
    g_b = jax.jit(jax.grad(loss(cfg_b), argnums=(0, 1)))(params, xj)
    for k in g_a[0]:
        np.testing.assert_allclose(
            np.asarray(g_b[0][k]), np.asarray(g_a[0][k]), rtol=2e-4,
            atol=1e-6, err_msg=f"param grad {k}")
    np.testing.assert_allclose(np.asarray(g_b[1]), np.asarray(g_a[1]),
                               rtol=2e-4, atol=1e-6, err_msg="input grad")


def test_batched_grad_budget_fallback(rng, monkeypatch):
    """Over-budget residual stacks fall back to the autodiff scan (same
    values) instead of allocating."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from drnmf_tpu.models import init_drnmf_params
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input

    f, r = 7, 3
    cfg = dataclasses.replace(
        DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2, alph=8.0,
                    lam1=0.3, params_untied=("log_D",),
                    params_trainable=("log_D",)),
        batched_grad=True)
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(cfg, w)
    x = jnp.asarray(rng.uniform(0, 1, (2, 5, f)).astype(np.float32))
    sm = step_mask_from_input(x, cfg.mask_value)
    hs_ok = _scan_hidden(params, cfg, x, sm)
    monkeypatch.setenv("DRNMF_BATCHED_GRAD_BUDGET_BYTES", "1")
    hs_fb = _scan_hidden(params, cfg, x, sm)
    np.testing.assert_allclose(np.asarray(hs_fb), np.asarray(hs_ok),
                               rtol=1e-6, atol=1e-7)

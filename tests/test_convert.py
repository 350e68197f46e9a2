"""Keras-HDF5 weight import: write a checkpoint in the reference's exact
save_weights layout, import it, and run the model."""

import numpy as np

from drnmf_tpu.models import (
    DRNMFConfig,
    init_drnmf_params,
    drnmf_apply,
    LSTMConfig,
    init_lstm_params,
    lstm_apply,
)
from drnmf_tpu.utils.convert import (
    import_drnmf_keras_weights,
    import_lstm_keras_weights,
)


def write_keras_h5(path, layers):
    """layers: list of (layer_name, [(weight_name, array), ...]) in the
    Keras 2.0.4 save_weights layout.  h5py (the optional [hdf5] extra) is
    imported here, so the module collects on a machine without it."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [name.encode() for name, _ in layers]
        )
        for name, weights in layers:
            grp = f.create_group(name)
            grp.attrs["weight_names"] = np.array(
                [wn.encode() for wn, _ in weights]
            )
            for wn, arr in weights:
                grp.create_dataset(wn, data=arr)


def test_import_drnmf_roundtrip(tmp_path, rng):
    f, r, K = 9, 3, 2
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.5,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)
    # perturb so the import is distinguishable from re-init
    params = {k: np.asarray(v) + 0.01 for k, v in params.items()}

    rnn = "simple_deep_rnn_1"
    rnn_weights = [(f"{rnn}_log_h0", params["log_h0"]),
                   (f"{rnn}_log_U1", params["log_U1"]),
                   (f"{rnn}_log_Uk", params["log_Uk"])]
    for k in range(K):
        rnn_weights.append((f"{rnn}_log_D_{k}", params[f"log_D_{k}"]))
        rnn_weights.append((f"{rnn}_log_alph_{k}", params[f"log_alph_{k}"]))
    rnn_weights.append((f"{rnn}_log_lam1", params["log_lam1"]))
    path = str(tmp_path / "model_unfolded_snmf_abc.hdf5")
    write_keras_h5(path, [
        ("masking_1", []),
        (rnn, rnn_weights),
        ("clean_est", [("clean_est/kernel:0", params["log_W_clean"])]),
        ("noise_est", [("noise_est/kernel:0", params["log_W_noise"])]),
    ])

    imported = import_drnmf_keras_weights(path)
    assert set(imported) == set(params)
    for k in params:
        np.testing.assert_array_equal(imported[k], params[k])
    # imported weights drive the model
    x = rng.uniform(0, 1, (2, 5, f)).astype(np.float32)
    irm = np.asarray(drnmf_apply(
        {k: np.asarray(v) for k, v in imported.items()}, config, x))
    assert np.all((irm >= 0) & (irm <= 1))


def test_import_lstm_roundtrip(tmp_path, rng):
    config = LSTMConfig(input_dim=7, hidden_dim=5, output_dim=7, K_layers=2)
    params = {k: np.asarray(v) for k, v in init_lstm_params(config).items()}

    path = str(tmp_path / "model_lstm_abc.hdf5")
    write_keras_h5(path, [
        ("masking_1", []),
        ("lstm_1", [("lstm_1/kernel:0", params["lstm0_Wx"]),
                    ("lstm_1/recurrent_kernel:0", params["lstm0_Wh"]),
                    ("lstm_1/bias:0", params["lstm0_b"])]),
        ("lstm_2", [("lstm_2/kernel:0", params["lstm1_Wx"]),
                    ("lstm_2/recurrent_kernel:0", params["lstm1_Wh"]),
                    ("lstm_2/bias:0", params["lstm1_b"])]),
        ("time_distributed_1", [
            ("time_distributed_1/kernel:0", params["dense_W"]),
            ("time_distributed_1/bias:0", params["dense_b"]),
        ]),
    ])
    imported = import_lstm_keras_weights(path)
    assert set(imported) == set(params)
    for k in params:
        np.testing.assert_array_equal(imported[k], params[k])
    x = rng.uniform(0, 1, (2, 4, 7)).astype(np.float32)
    mask_out = np.asarray(lstm_apply(imported, config, x))
    assert np.all((mask_out >= 0) & (mask_out <= 1))


def test_import_rejects_wrong_file(tmp_path):
    import pytest

    path = str(tmp_path / "other.hdf5")
    write_keras_h5(path, [("dense_1", [("dense_1/kernel:0",
                                        np.zeros((3, 3), np.float32))])])
    with pytest.raises(ValueError, match="does not look like"):
        import_drnmf_keras_weights(path)
    with pytest.raises(ValueError, match="does not look like"):
        import_lstm_keras_weights(path)


def test_import_drnmf_tied_layout(tmp_path, rng):
    """TIED alt params (no per-layer _k suffixes -- params_untied empty,
    the reference's default when 'params_untied' is absent)."""
    f, r, K = 7, 3, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.5, params_untied=())
    params = {k: np.asarray(v)
              for k, v in init_drnmf_params(config, w).items()}

    rnn = "simple_deep_rnn_1"
    rnn_weights = [(f"{rnn}_log_h0", params["log_h0"]),
                   (f"{rnn}_log_U1", params["log_U1"]),
                   (f"{rnn}_log_Uk", params["log_Uk"]),
                   (f"{rnn}_log_D", params["log_D"]),
                   (f"{rnn}_log_alph", params["log_alph"]),
                   (f"{rnn}_log_lam1", params["log_lam1"])]
    path = str(tmp_path / "model_unfolded_snmf_tied.hdf5")
    write_keras_h5(path, [
        ("masking_1", []),
        (rnn, rnn_weights),
        ("clean_est", [("clean_est/kernel:0", params["log_W_clean"])]),
        ("noise_est", [("noise_est/kernel:0", params["log_W_noise"])]),
    ])
    imported = import_drnmf_keras_weights(path)
    assert set(imported) == set(params)
    from drnmf_tpu.utils.convert import validate_drnmf_import

    validate_drnmf_import(imported, config)
    x = rng.uniform(0, 1, (2, 4, f)).astype(np.float32)
    irm = np.asarray(drnmf_apply(imported, config, x))
    assert np.all((irm >= 0) & (irm <= 1))


def test_import_drnmf_untied_alph_vector(tmp_path, rng):
    """untie_alph: per-layer (2r,) alph VECTORS import + validate."""
    f, r, K = 6, 2, 2
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.5, untie_alph=True,
                         params_untied=("log_D", "log_alph"))
    params = {k: np.asarray(v)
              for k, v in init_drnmf_params(config, w).items()}
    rnn = "simple_deep_rnn_1"
    rnn_weights = [(f"{rnn}_log_h0", params["log_h0"]),
                   (f"{rnn}_log_U1", params["log_U1"]),
                   (f"{rnn}_log_Uk", params["log_Uk"]),
                   (f"{rnn}_log_lam1", params["log_lam1"])]
    for k in range(K):
        rnn_weights += [(f"{rnn}_log_D_{k}", params[f"log_D_{k}"]),
                        (f"{rnn}_log_alph_{k}", params[f"log_alph_{k}"])]
    path = str(tmp_path / "model_unfolded_snmf_ua.hdf5")
    write_keras_h5(path, [
        (rnn, rnn_weights),
        ("clean_est", [("clean_est/kernel:0", params["log_W_clean"])]),
        ("noise_est", [("noise_est/kernel:0", params["log_W_noise"])]),
    ])
    imported = import_drnmf_keras_weights(path)
    from drnmf_tpu.utils.convert import validate_drnmf_import

    validate_drnmf_import(imported, config)
    for k in params:
        np.testing.assert_array_equal(imported[k], params[k])


def test_import_lstm_deep_stack(tmp_path, rng):
    """K=5 LSTM stack (the paper's deepest baseline)."""
    config = LSTMConfig(input_dim=6, hidden_dim=4, output_dim=6, K_layers=5)
    params = {k: np.asarray(v) for k, v in init_lstm_params(config).items()}
    layers = [("masking_1", [])]
    for k in range(5):
        nm = f"lstm_{k + 1}"
        layers.append((nm, [(f"{nm}/kernel:0", params[f"lstm{k}_Wx"]),
                            (f"{nm}/recurrent_kernel:0", params[f"lstm{k}_Wh"]),
                            (f"{nm}/bias:0", params[f"lstm{k}_b"])]))
    layers.append(("time_distributed_1", [
        ("time_distributed_1/kernel:0", params["dense_W"]),
        ("time_distributed_1/bias:0", params["dense_b"])]))
    path = str(tmp_path / "model_lstm_k5.hdf5")
    write_keras_h5(path, layers)
    imported = import_lstm_keras_weights(path)
    assert set(imported) == set(params)
    from drnmf_tpu.utils.convert import validate_lstm_import

    validate_lstm_import(imported, config)
    x = rng.uniform(0, 1, (2, 4, 6)).astype(np.float32)
    out = np.asarray(lstm_apply(imported, config, x))
    assert np.all((out >= 0) & (out <= 1))


def test_validate_import_catches_transpose_and_mismatch(rng):
    """Shape validation names transposed kernels and key-set mismatches
    (the silent failure modes of a layout change)."""
    import pytest
    from drnmf_tpu.utils.convert import (
        validate_drnmf_import, validate_lstm_import)

    f, r = 7, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.5,
                         params_untied=("log_D", "log_alph"))
    params = {k: np.asarray(v)
              for k, v in init_drnmf_params(config, w).items()}
    validate_drnmf_import(params, config)  # pristine passes

    bad = dict(params)
    bad["log_W_clean"] = params["log_W_clean"].T  # (F, r): transposed
    with pytest.raises(ValueError, match="transposed"):
        validate_drnmf_import(bad, config)

    missing = {k: v for k, v in params.items() if k != "log_D_1"}
    with pytest.raises(ValueError, match="missing.*log_D_1"):
        validate_drnmf_import(missing, config)

    # K mismatch: a K=3 checkpoint against a K=2 config
    extra = dict(params)
    extra["log_D_2"] = params["log_D_0"]
    with pytest.raises(ValueError, match="unexpected.*log_D_2"):
        validate_drnmf_import(extra, config)

    # nonnegative=False: params carry plain 'h0' instead of 'log_h0'
    # (init_drnmf_params) and must validate, not be reported as unexpected
    cfg_nn = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.5, nonnegative=False,
                         params_untied=("log_D", "log_alph"))
    p_nn = {k: np.asarray(v)
            for k, v in init_drnmf_params(cfg_nn, w).items()}
    assert "h0" in p_nn and "log_h0" not in p_nn
    validate_drnmf_import(p_nn, cfg_nn)

    lcfg = LSTMConfig(input_dim=5, hidden_dim=3, output_dim=5, K_layers=1)
    lp = {k: np.asarray(v) for k, v in init_lstm_params(lcfg).items()}
    validate_lstm_import(lp, lcfg)
    lbad = dict(lp)
    lbad["dense_W"] = lp["dense_W"].T
    with pytest.raises(ValueError, match="transposed"):
        validate_lstm_import(lbad, lcfg)


def test_lstm_cell_matches_real_keras(rng):
    """Cross-check of the Keras-2.0.4 LSTM cell semantics this framework
    reimplements (models/lstm.py; gate order i,f,c,o in the packed kernel,
    packed-bias layout, carry recurrence) against a REAL Keras LSTM
    (the migration claim should rest on more than a hand-built
    fixture).  The installed Keras 3 defaults differ from 2.0.4
    only in the recurrent activation (hard_sigmoid slope 1/6 vs 0.2), so
    the 2.0.4 hard_sigmoid is passed explicitly; everything else -- the
    weight layout import_lstm_keras_weights maps -- is validated by exact
    agreement of the sequence outputs."""
    import pytest

    keras = pytest.importorskip("keras")
    import numpy as np

    f, n, B, T = 5, 4, 2, 7
    wx = rng.standard_normal((f, 4 * n)).astype(np.float32) * 0.4
    wh = rng.standard_normal((n, 4 * n)).astype(np.float32) * 0.4
    b = rng.standard_normal((4 * n,)).astype(np.float32) * 0.1
    x = rng.standard_normal((B, T, f)).astype(np.float32)

    def hs_204(z):  # Keras 2.0.4 hard_sigmoid
        return keras.ops.clip(0.2 * z + 0.5, 0.0, 1.0)

    layer = keras.layers.LSTM(
        n, return_sequences=True, activation="tanh",
        recurrent_activation=hs_204, unit_forget_bias=False)
    layer.build((B, T, f))
    layer.set_weights([wx, wh, b])
    want = np.asarray(layer(x))

    from drnmf_tpu.models.lstm import _lstm_layer

    got = np.asarray(_lstm_layer(wx, wh, b, x, np.ones((B, T), bool)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

"""End-to-end pipeline tests on the synthetic corpus: the full reference
flow (featurize -> SNMF dict -> DR-NMF train -> enhance -> score) in
miniature, for all three model families."""

import os

import numpy as np
import pytest

from drnmf_tpu.data import make_synthetic_corpus
from drnmf_tpu import pipeline
from drnmf_tpu.cli import dispatch_model_type


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    taskfiles = make_synthetic_corpus(str(root / "audio"), n_files=6,
                                      min_sec=0.5, max_sec=0.9)
    params_data = {
        "taskfile_x_train": taskfiles["noisy"],
        "taskfile_y_train": taskfiles["clean"],
        "taskfile_x_valid": taskfiles["noisy"],
        "taskfile_y_valid": taskfiles["clean"],
        "taskfile_x_test": taskfiles["noisy"],
        "taskfile_y_test": taskfiles["clean"],
        "transform_x": "mag",
        "transform_y": "mag",
        "params_stft": {"N": 256, "hop": 64, "nch": 1},
        "maxlen": 60,
        "downsample": 1,
    }
    folder_exp = str(root / "exp")
    return params_data, folder_exp


MODEL_SMALL = {
    "K_layers": 2,
    "r": 8,
    "alph": 10.0,
    "lam1": 0.5,
    "epochs": 3,
    "batch_size": 4,
    "learning_rate": 1e-3,
    "clipnorm": 0.0,
    "patience": 50,
    "params_untied": ["log_D", "log_alph"],
    "params_trainable": ["log_D", "log_alph"],
    "snmf_max_iter": 30,
    "snmf_conv_eps": 1e-4,
}


def test_unfolded_snmf_end_to_end(setup):
    params_data, folder_exp = setup
    best, config, results = pipeline.run_unfolded_snmf(
        MODEL_SMALL, params_data, folder_exp, verbose=False,
        splits=("valid",),
    )
    overall, per_snr = results["valid"]
    assert overall.shape == (1, 6)
    # enhancement should beat doing nothing on SDR for at least most files;
    # sanity: scores are finite
    assert np.all(np.isfinite(overall[:, [0, 1, 2, 3, 5]]))
    # artifacts exist
    assert os.path.isdir(os.path.join(folder_exp, "models"))
    assert any(f.startswith("model_unfolded_snmf") for f in
               os.listdir(os.path.join(folder_exp, "models")))

    # rerun hits every cache (no retrain): same results
    best2, _, results2 = pipeline.run_unfolded_snmf(
        MODEL_SMALL, params_data, folder_exp, verbose=False, splits=("valid",),
    )
    np.testing.assert_array_equal(results2["valid"][0], overall)


def test_snmf_end_to_end(setup):
    params_data, folder_exp = setup
    model = {"r": 8, "lam1": 0.5, "snmf_max_iter": 30, "infer_max_iter": 30}
    w, p, results = pipeline.run_snmf(
        model, params_data, folder_exp, verbose=False, splits=("valid",),
    )
    assert w.shape[1] == 16
    overall, _ = results["valid"]
    assert np.all(np.isfinite(overall[:, [0, 1, 2, 3, 5]]))
    # val_loss histfile written in reference layout
    import pickle, glob

    hists = glob.glob(os.path.join(folder_exp, "history", "history_snmf_*"))
    assert hists
    with open(hists[0], "rb") as f:
        h = pickle.load(f)
    assert "val_loss" in h["on_epoch_end"]


def test_lstm_end_to_end(setup):
    params_data, folder_exp = setup
    model = {
        "K_layers": 1, "hidden_dim": 16, "epochs": 2, "batch_size": 4,
        "learning_rate": 1e-3, "clipnorm": 1.0, "patience": 50,
    }
    best, config, results = pipeline.run_lstm(
        model, params_data, folder_exp, verbose=False, splits=("valid",),
    )
    overall, _ = results["valid"]
    assert np.all(np.isfinite(overall[:, [0, 1, 2, 3, 5]]))


def test_model_dispatch():
    assert dispatch_model_type("params_unfolded_snmf_abc.yaml") == "unfolded_snmf"
    assert dispatch_model_type("configs/params_snmf_x.yaml") == "snmf"
    assert dispatch_model_type("params_lstm_1.yaml") == "lstm"
    with pytest.raises(ValueError):
        dispatch_model_type("params_foo.yaml")


def test_cli_smoke(setup, tmp_path):
    """CLI -c/-d invocation end to end (train only, no scoring)."""
    from drnmf_tpu.utils import dump_yaml
    from drnmf_tpu.cli import main

    params_data, folder_exp = setup
    cfg = dict(MODEL_SMALL)
    cfg["epochs"] = 1
    c_path = str(tmp_path / "params_unfolded_snmf_test.yaml")
    d_path = str(tmp_path / "params_data.yaml")
    dump_yaml(cfg, c_path)
    dump_yaml(params_data, d_path)
    main(["-c", c_path, "-d", d_path, "--exp-dir", folder_exp,
          "--no-score", "-q", "--no-compile-cache"])


def test_reporting(setup):
    from drnmf_tpu.reporting import summarize_experiment, latex_table

    _, folder_exp = setup
    rows = summarize_experiment(folder_exp)
    assert any("unfolded_snmf" in r["model"] for r in rows)
    table = latex_table([("drnmf", 2, 16, 1000, 0.123, 8.5)])
    assert "drnmf" in table and r"\\" in table


def test_unfolded_snmf_pretrain_with_snmf_cost(setup):
    """SNMF-cost pretraining path (enhance.py:1024-1120): pretrain artifacts
    are written and the main training warm-starts from them."""
    params_data, folder_exp = setup
    model = dict(MODEL_SMALL)
    model["pretrain_with_snmf_cost"] = True
    model["epochs"] = 2
    best, config, results = pipeline.run_unfolded_snmf(
        model, params_data, folder_exp, verbose=False, splits=(),
        flag_score=False,
    )
    models_dir = os.path.join(folder_exp, "models")
    hist_dir = os.path.join(folder_exp, "history")
    assert any(f.endswith("_pretrain.npz") for f in os.listdir(models_dir))
    assert any(f.endswith("_pretrain") for f in os.listdir(hist_dir))
    # pretrain history records a finite SNMF-cost val loss
    import pickle
    pre_hist = [f for f in os.listdir(hist_dir) if f.endswith("_pretrain")][0]
    with open(os.path.join(hist_dir, pre_hist), "rb") as f:
        hist = pickle.load(f)
    assert np.all(np.isfinite(hist["on_epoch_end"]["val_loss"]))


def test_unfolded_snmf_with_dropout(setup):
    """Dropout flags wire through the YAML config into training (variational
    dropout, rng threaded per batch); eval stays deterministic."""
    params_data, folder_exp = setup
    model = dict(MODEL_SMALL)
    model.update(dropout_W=0.2, dropout_U=0.2, epochs=2)
    best, config, _ = pipeline.run_unfolded_snmf(
        model, params_data, folder_exp, verbose=False, splits=(),
        flag_score=False,
    )
    assert config.dropout_W == 0.2
    import pickle
    h = [f for f in os.listdir(os.path.join(folder_exp, "history"))
         if not f.endswith("_pretrain")]
    assert h  # trained and recorded history


def test_enhance_signals_api(rng):
    """Fused batch enhance == per-utterance STFT->mask->iSTFT composition."""
    import jax.numpy as jnp
    from drnmf_tpu.dsp import stft, istft
    from drnmf_tpu.enhance import enhance_signals
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.models.drnmf import drnmf_forward

    n_fft, hop = 256, 64
    f = n_fft // 2 + 1
    w = rng.uniform(0.05, 1.0, (f, 16)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=8, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.5)
    params = init_drnmf_params(config, w)
    sigs = [
        (rng.standard_normal(rng.integers(2000, 4000)) * 0.2).astype(np.float32)
        for _ in range(3)
    ]
    outs = enhance_signals(params, config, sigs, n_fft, hop, batch_size=2)
    assert [len(o) for o in outs] == [len(s) for s in sigs]
    for s, o in zip(sigs, outs):
        spec = stft(jnp.asarray(s), n_fft, hop)
        irm = drnmf_forward(params, config, jnp.abs(spec)[None])[0]
        ref = np.asarray(istft(spec * irm.astype(spec.dtype), n_fft, hop,
                               nsampl=len(s)))
        np.testing.assert_allclose(o, ref, rtol=1e-4, atol=1e-5)


def test_resume_reenters_training_after_interruption(setup):
    """With resume: true, a best checkpoint + an incomplete train-state file
    re-enters training instead of short-circuiting on the checkpoint."""
    import pickle

    params_data, folder_exp = setup
    model = dict(MODEL_SMALL)
    model.update(epochs=3, resume=True, r=9)  # unique hash for this test
    pipeline.run_unfolded_snmf(model, params_data, folder_exp, verbose=False,
                               splits=(), flag_score=False)
    from drnmf_tpu.utils import config_hash
    h = config_hash(model, exclude=("resume",))
    savefile = os.path.join(folder_exp, "models", f"model_unfolded_snmf_{h}.npz")
    state_file = savefile + ".train_state"
    assert os.path.exists(state_file)

    # simulate a crash after epoch 0: rewind the state file
    with open(state_file, "rb") as f:
        state = pickle.load(f)
    assert not state["finished"]
    state["epoch"] = 0
    with open(state_file, "wb") as f:
        pickle.dump(state, f)

    hist_file = os.path.join(folder_exp, "history", f"history_unfolded_snmf_{h}")
    with open(hist_file, "rb") as f:
        before = len(pickle.load(f)["on_epoch_end"]["val_loss"])

    pipeline.run_unfolded_snmf(model, params_data, folder_exp, verbose=False,
                               splits=(), flag_score=False)
    with open(hist_file, "rb") as f:
        after = len(pickle.load(f)["on_epoch_end"]["val_loss"])
    # epochs 1..2 re-ran and appended to the PRESERVED history
    assert after == before + 2

    # the resume key does not change the experiment hash
    assert config_hash(model, exclude=("resume",)) == config_hash(
        {k: v for k, v in model.items() if k != "resume"}
    )


def test_batched_reconstruct_matches_per_utterance(setup, rng):
    """Bucketed batch reconstruction writes the same wavs as the reference's
    per-utterance loop."""
    from drnmf_tpu.data import AudioDataset
    from drnmf_tpu.dsp.wav import wavread_fs

    params_data, folder_exp = setup
    ds = AudioDataset(
        params_data["taskfile_x_valid"], params_data["taskfile_y_valid"],
        params_stft=params_data["params_stft"],
    )
    n = len(ds.x_wavfiles)
    maxT = int(np.max(ds.fidx[:, 1] - ds.fidx[:, 0]))
    f_bins = params_data["params_stft"]["N"] // 2 + 1
    irm = rng.uniform(0.2, 1.0, (n, maxT, f_bins)).astype(np.float32)

    pipeline.reconstruct_split(ds, irm, None, "batched_recon")
    for j in range(n):
        ds.reconstruct_audio(
            "peru_recon", idx=j,
            irm=irm[j, : int(ds.fidx[j, 1] - ds.fidx[j, 0]), :].T,
        )
    for j in range(n):
        a, _ = wavread_fs(ds.enhanced_path(j, "batched_recon"))
        b, _ = wavread_fs(ds.enhanced_path(j, "peru_recon"))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_logmag_transform_end_to_end(setup):
    """logmag features flow through training and scoring (the reference had
    a transform-key quirk here; our mask value is -1 for logmag too)."""
    params_data, folder_exp = setup
    pd = dict(params_data)
    pd.update(transform_x="logmag", transform_y="logmag")
    model = dict(MODEL_SMALL)
    model.update(epochs=1, r=7)  # unique hash
    best, config, _ = pipeline.run_unfolded_snmf(
        model, pd, folder_exp, verbose=False, splits=(), flag_score=False,
    )
    assert config.mask_value == -1.0


def test_predict_irm_bucketed_matches_full(rng):
    """Length-bucketed prediction == full-padded prediction (the model holds
    state on padded steps either way)."""
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params, drnmf_apply

    f, r = 9, 4
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.5)
    params = init_drnmf_params(config, w)

    n, t_max = 7, 300
    x = np.full((n, t_max, f), config.mask_value, np.float32)
    lens = [40, 120, 120, 260, 300, 10, 180]
    for i, ln in enumerate(lens):
        x[i, :ln] = rng.uniform(0, 1, (ln, f)).astype(np.float32)

    apply_fn = lambda p, xb: drnmf_apply(p, config, xb)
    fast = pipeline.predict_irm(apply_fn, params, x, batch_size=3)
    full = np.zeros_like(x)
    for s in range(0, n, 3):
        full[s : s + 3] = np.asarray(apply_fn(params, x[s : s + 3]))
    for i, ln in enumerate(lens):
        np.testing.assert_allclose(fast[i, :ln], full[i, :ln],
                                   rtol=1e-5, atol=1e-6)


def test_predict_irm_interior_maskvalue_frame(rng):
    """With mask_value=0.0 (logmag configs), an all-zero frame INSIDE a valid
    sequence must not shorten the inferred length -- lengths come from the
    last valid frame, not a validity count."""
    import jax.numpy as jnp
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params, drnmf_apply

    f, r = 7, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=2,
                         alph=10.0, lam1=0.5, mask_value=0.0)
    params = init_drnmf_params(config, w)

    n, t_max = 3, 40
    x = np.zeros((n, t_max, f), np.float32)
    lens = [30, 40, 12]
    for i, ln in enumerate(lens):
        x[i, :ln] = rng.uniform(0.1, 1, (ln, f)).astype(np.float32)
    x[0, 15] = 0.0  # interior silent frame; true length is still 30

    apply_fn = lambda p, xb: drnmf_apply(p, config, xb)
    fast = pipeline.predict_irm(apply_fn, params, x, mask_value=0.0,
                                bucket_frames=8)
    full = np.asarray(apply_fn(params, x))
    for i, ln in enumerate(lens):
        np.testing.assert_allclose(fast[i, :ln], full[i, :ln],
                                   rtol=1e-5, atol=1e-6)


def test_unfolded_snmf_2d_mesh_training(setup, tmp_path):
    """Full pipeline (SNMF recipe -> train -> enhance -> score) with the
    combined 2-D dp x tp training mesh (cli --tp): batch over dp=4, the
    recurrence contraction over tp=2, on the virtual 8-device mesh."""
    from drnmf_tpu.parallel import make_mesh_2d

    params_data, _ = setup
    model = dict(MODEL_SMALL, epochs=2)  # hidden 16 over tp=2
    mesh = make_mesh_2d(4, 2)
    best, config, results = pipeline.run_unfolded_snmf(
        model, params_data, str(tmp_path / "exp2d"), verbose=False,
        splits=("valid",), mesh=mesh)
    overall, _ = results["valid"]
    assert overall.shape == (1, 6)
    assert np.all(np.isfinite(overall[:, [0, 1, 2, 3, 5]]))


def test_cli_tp_rejects_non_drnmf(tmp_path):
    """--tp is a DR-NMF recurrence option; the CLI refuses it for the
    lstm/snmf families instead of silently ignoring it."""
    import yaml
    from drnmf_tpu import cli

    cfg = tmp_path / "params_lstm_x.yaml"
    yaml.safe_dump({"hidden_dim": 8}, open(cfg, "w"))
    data = tmp_path / "params_data.yaml"
    yaml.safe_dump({}, open(data, "w"))
    with pytest.raises(SystemExit):
        cli.main(["-c", str(cfg), "-d", str(data), "--tp", "2"])


def test_unfolded_snmf_fsdp_training(setup, tmp_path):
    """Full pipeline with the ZeRO-3 layout (cli --fsdp): params + Adam
    moments sharded over dp=8; end-to-end scores stay finite.  fsdp is run
    control, so the artifact hash matches a replicated run's."""
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.utils.config import config_hash

    params_data, _ = setup
    model = dict(MODEL_SMALL, epochs=2, fsdp=True)
    assert (config_hash(model, exclude=("resume", "fsdp"))
            == config_hash(dict(MODEL_SMALL, epochs=2),
                           exclude=("resume", "fsdp")))
    best, config, results = pipeline.run_unfolded_snmf(
        model, params_data, str(tmp_path / "expfsdp"), verbose=False,
        splits=("valid",), mesh=make_mesh(8))
    overall, _ = results["valid"]
    assert overall.shape == (1, 6)
    assert np.all(np.isfinite(overall[:, [0, 1, 2, 3, 5]]))


def test_cli_fsdp_requires_dp(tmp_path):
    """--fsdp without a data-parallel mesh (--dp 1) is a usage error, not a
    silent no-op."""
    import yaml
    from drnmf_tpu import cli

    cfg = tmp_path / "params_unfolded_snmf_x.yaml"
    yaml.safe_dump(dict(MODEL_SMALL), open(cfg, "w"))
    data = tmp_path / "params_data.yaml"
    yaml.safe_dump({}, open(data, "w"))
    with pytest.raises(SystemExit):
        cli.main(["-c", str(cfg), "-d", str(data), "--dp", "1", "--fsdp"])


def test_unfolded_snmf_fsdp_composes_with_2d_mesh(setup, tmp_path):
    """--fsdp on a 2-D (dp, tp) mesh with SNMF-cost pretraining: params
    shard over dp (the tp forward all-gathers them at use, FSDP
    semantics); the pretrain fit (plain forward under GSPMD) and the
    tp-sharded main fit both run; scores stay finite."""
    from drnmf_tpu.parallel import make_mesh_2d

    params_data, _ = setup
    model = dict(MODEL_SMALL, epochs=2, fsdp=True,
                 pretrain_with_snmf_cost=True)
    mesh = make_mesh_2d(4, 2)
    best, config, results = pipeline.run_unfolded_snmf(
        model, params_data, str(tmp_path / "exp2dfs"), verbose=False,
        splits=("valid",), mesh=mesh)
    overall, _ = results["valid"]
    assert overall.shape == (1, 6)
    assert np.all(np.isfinite(overall[:, [0, 1, 2, 3, 5]]))


@pytest.mark.parametrize("flags,expect", [
    ([], [None]),  # default: $JAX_COMPILATION_CACHE_DIR, else the checkout's
    (["--compile-cache", "CACHE"], ["CACHE"]),
    (["--no-compile-cache"], []),
])
def test_cli_compile_cache_choice(tmp_path, monkeypatch, flags, expect):
    """The CLI hands enable_compile_cache no directory by default (so the
    env-or-checkout rule decides), an explicit --compile-cache verbatim,
    and nothing with --no-compile-cache."""
    import drnmf_tpu.utils
    from drnmf_tpu import cli
    from drnmf_tpu.utils import dump_yaml

    seen = []
    monkeypatch.setattr(drnmf_tpu.utils, "enable_compile_cache", seen.append)
    monkeypatch.setattr(cli.pipeline, "run_unfolded_snmf",
                        lambda *a, **k: None)
    cfg = str(tmp_path / "params_unfolded_snmf_x.yaml")
    data = str(tmp_path / "params_data.yaml")
    dump_yaml(dict(MODEL_SMALL), cfg)
    dump_yaml({}, data)
    flags = [str(tmp_path / f) if f == "CACHE" else f for f in flags]
    cli.main(["-c", cfg, "-d", data, "--dp", "1", "-q", *flags])
    assert seen == [str(tmp_path / e) if e == "CACHE" else e for e in expect]

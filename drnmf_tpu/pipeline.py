"""End-to-end experiment pipeline: the reference driver's main() flow
(enhance.py:459-1437) as composable functions.

Stages: data load (cached tensors) -> SNMF dictionary (cached) -> model
build/train (cached best checkpoint) -> full-length mask prediction ->
audio reconstruction -> per-SNR scoring.  Every artifact is named by the
md5 hash of its config (the reference's experiment registry), so reruns are
idempotent and resume from caches.
"""

import os
import pickle

import numpy as np

from .data import AudioDataset, load_split, masked_seqs_to_frames
from .data.batching import get_mask_value
from .models import (
    DRNMFConfig,
    init_drnmf_params,
    drnmf_apply,
    drnmf_trainable_mask,
    LSTMConfig,
    init_lstm_params,
    lstm_apply,
    snmf_infer_irm,
)
from .models.drnmf import ensure_fold_valid
from .ops import SNMFParams
from .train import (
    TrainConfig,
    train_model,
    masked_mse_signal_approx,
    snmf_pretrain_loss,
    train_snmf,
    load_checkpoint,
)
from .utils import config_hash, dump_yaml, ensure_experiment_dirs, StageTimer
from .metrics.scoring import score_dataset, aggregate_snr_scores, SCORE_LABELS


def dataset_audio_seconds(dataset, fs=None):
    """Approximate audio duration from frame counts (frames * hop / fs)."""
    hop = int(dataset.params_stft["hop"])
    n_frames = int(np.sum(dataset.fidx[:, 1] - dataset.fidx[:, 0]))
    return n_frames * hop / (dataset.fs if fs is None else fs)

SNRS = ["m6dB", "m3dB", "0dB", "3dB", "6dB", "9dB"]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def build_datasets(params_data, splits=("train", "valid", "test")):
    """AudioDataset per split (enhance.py:740-743)."""
    out = {}
    for split in splits:
        ds = AudioDataset(
            params_data[f"taskfile_x_{split}"],
            params_data[f"taskfile_y_{split}"],
            datafile=params_data.get(f"datafile_{split}"),
            params_stft=params_data["params_stft"],
            downsample=params_data.get("downsample", 1) if split == "train" else 1,
            flag_unwrap_phase=bool(params_data.get("flag_unwrap_phase", False)),
        )
        out[split] = ds
    return out


def load_tensors(dataset, params_data, maxlen, cache_path=None):
    """(x, y, mask) tensors with HDF5-style npz caching (enhance.py:363-382)."""
    if cache_path is not None and os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["x"], data["y"], data["mask"]
    x, y, mask = load_split(
        dataset,
        transform_x=params_data.get("transform_x", "mag"),
        transform_y=params_data.get("transform_y", "mag"),
        maxlen=maxlen,
    )
    if cache_path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        np.savez(cache_path, x=x, y=y, mask=mask)
    return x, y, mask


# ---------------------------------------------------------------------------
# mask prediction (full-length, batched -- no graph rebuild needed)
# ---------------------------------------------------------------------------

def predict_irm(apply_fn, params, x, batch_size=250, mask_value=-1.0,
                bucket_frames=128):
    """Predict masks for a padded (B, T_max, F) split, bucketed by length.

    Full-split tensors are padded to the longest utterance; running every
    sequence at T_max wastes 2-3x compute on a real corpus.  Rows are
    grouped by true length into T buckets (multiples of ``bucket_frames``,
    so compiled-program count stays O(T_max/bucket)); each bucket runs at
    its own truncated T.  The per-row mask semantics are unchanged -- the
    model holds state on padded steps either way."""
    irm = np.zeros_like(x)
    # per-row true length = index of the last non-padded frame + 1 (padding
    # is a contiguous tail, but interior frames may coincidentally equal the
    # mask value -- counting valid frames would undershoot then)
    valid = np.any(x != mask_value, axis=-1)  # (B, T)
    t_max = x.shape[1]
    lengths = np.where(
        valid.any(axis=1), t_max - valid[:, ::-1].argmax(axis=1), 0
    )
    buckets = {}
    for i, ln in enumerate(lengths):
        t_b = min(t_max, -(-max(int(ln), 1) // bucket_frames) * bucket_frames)
        buckets.setdefault(t_b, []).append(i)
    for t_b, rows in sorted(buckets.items()):
        rows = np.asarray(rows)
        for start in range(0, len(rows), batch_size):
            idx = rows[start : start + batch_size]
            irm[idx, :t_b] = np.asarray(apply_fn(params, x[idx, :t_b]))
    return irm


def reconstruct_split(dataset, irm, mask, description, fs=None,
                      bucket_frames=256):
    """Masked iSTFT + wav write for a whole split.

    The reference looped one utterance at a time (enhance.py:1195-1203);
    dispatching thousands of tiny device programs dominates reconstruction
    wall-clock, so utterances are grouped into frame-count buckets and
    inverse-transformed as batches (zero-padded frames synthesize zeros and
    are trimmed).  Falls back to the per-utterance path for nch > 1.
    """
    import jax.numpy as jnp

    from .dsp import istft, wavwrite

    if fs is None:
        fs = dataset.fs
    n_fft = int(dataset.params_stft["N"])
    hop = int(dataset.params_stft["hop"])
    f_bins = n_fft // 2 + 1
    half = dataset.x_stack.shape[0] // 2
    if half != f_bins:  # multichannel: keep the simple path
        for j in range(len(dataset.x_wavfiles)):
            len_cur = int(dataset.fidx[j, 1] - dataset.fidx[j, 0])
            dataset.reconstruct_audio(description, idx=j,
                                      irm=irm[j, :len_cur, :].T)
        return

    lens = (dataset.fidx[:, 1] - dataset.fidx[:, 0]).astype(int)
    if irm.shape[0] != len(dataset.x_wavfiles) or irm.shape[1] < lens.max():
        raise ValueError(
            f"reconstruct_split needs one irm row per wav file at full "
            f"length (build inference tensors with maxlen=None): got "
            f"irm {irm.shape} for {len(dataset.x_wavfiles)} files with "
            f"max {int(lens.max())} frames")
    buckets = {}
    for j, ln in enumerate(lens):
        buckets.setdefault(-(-ln // bucket_frames) * bucket_frames, []).append(j)

    window = jnp.asarray(np.asarray(dataset.params_stft["window"], np.float32))
    for t_pad, idxs in sorted(buckets.items()):
        spec = np.zeros((len(idxs), t_pad, f_bins), np.complex64)
        for row, j in enumerate(idxs):
            seg = dataset.x_stack[:, dataset.fidx[j, 0] : dataset.fidx[j, 1]]
            masked = irm[j, : lens[j], :].T * (seg[:half] + 1j * seg[half:])
            spec[row, : lens[j]] = masked.T
        wavs = np.asarray(istft(spec, n_fft, hop, window))
        for row, j in enumerate(idxs):
            # per-utterance parity: istft with nsampl=None trims the OLA of
            # L frames (N + hop*(L-1) samples) by N at each edge
            nsampl = hop * (lens[j] - 1) - n_fft
            out = dataset.enhanced_path(j, description)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            wavwrite(out, fs, wavs[row : row + 1, :nsampl])


def score_split(dataset, description, datadir, compute_pesq=True,
                flag_rescore=False, verbose=True, mesh=None):
    """Per-SNR scoring + overall aggregation (enhance.py:1396-1433).
    ``mesh``: optional jax Mesh -- score buckets shard their file rows
    over its first axis (metrics/sharded.py), identical scores."""
    per_snr = []
    for snr_name in SNRS:
        refs = [w for w in dataset.y_wavfiles if f"/{snr_name}/" in w]
        if not refs:
            continue
        if verbose:
            print(f"  scoring SNR {snr_name} ({len(refs)} files)")
        S, labels = score_dataset(
            dataset, description, snr_name=snr_name, datadir=datadir,
            compute_pesq=compute_pesq, flag_rescore=flag_rescore,
            mesh=mesh,
        )
        per_snr.append((S, labels))
    overall = aggregate_snr_scores(per_snr, len(dataset.y_wavfiles))
    if verbose:
        for label, val in zip(SCORE_LABELS, overall.ravel()):
            print(f"  overall mean {label}: {val:.3f}")
    return overall, per_snr


# ---------------------------------------------------------------------------
# model runners
# ---------------------------------------------------------------------------

def _dict_from_config(params_model, params_data, datasets, folder_exp,
                      path_dicts, flag_recompute=False, verbose=True):
    """Two-stage SNMF dictionary from training data (cached)."""
    params_snmf = SNMFParams(
        r=int(params_model["r"]),
        cf=params_model.get("cf", "ed"),
        sparsity=float(params_model.get("lam1", params_model.get("sparsity", 1.0))),
        max_iter=int(params_model.get("snmf_max_iter", 1000)),
        conv_eps=float(params_model.get("snmf_conv_eps", 1e-4)),
        random_seed=int(params_model.get("random_seed", 2016)),
    )
    from .utils.cache import snmf_cache_path

    cache = snmf_cache_path(params_snmf, path_dicts, prefix="noisy")
    if os.path.exists(cache) and not flag_recompute:
        from .utils.cache import load_snmf

        w_noisy, _, _ = load_snmf(cache, load_h=False)
        return w_noisy, params_snmf

    maxlen = params_data.get("maxlen", 500)
    x, y, mask = load_tensors(
        datasets["train"], params_data, maxlen,
        cache_path=os.path.join(
            folder_exp, f"tensors_train_ds{params_data.get('downsample', 1)}"
            f"_maxlen{maxlen}.npz",
        ),
    )
    x_frames = masked_seqs_to_frames(x, mask)
    y_frames = masked_seqs_to_frames(y, mask)
    w_noisy, _, _ = train_snmf(
        y_frames, x_frames, params_snmf, path_dicts=path_dicts,
        flag_recompute=flag_recompute, verbose=verbose,
    )
    return w_noisy, params_snmf


def drnmf_config_from_params(params_model, input_dim, mask_value=-1.0):
    """Build a DRNMFConfig from a model-config dict -- the single source of
    truth for YAML-key -> config mapping (used by the pipeline and the
    standalone inference tools; missing keys here once caused silently
    different architectures at inference time)."""
    return DRNMFConfig(
        input_dim=input_dim,
        r=int(params_model["r"]),
        output_dim=input_dim,
        K_layers=int(params_model["K_layers"]),
        alph=float(params_model["alph"]),
        lam1=float(params_model["lam1"]),
        mask_value=mask_value,
        untie_alph=bool(params_model.get("untie_alph", False)),
        params_untied=tuple(params_model.get("params_untied", [])),
        params_trainable=tuple(params_model.get("params_trainable", [])),
        transform_before_irm=params_model.get("transform_before_irm"),
        activation=params_model.get("activation", "relu"),
        connect_input_to_layers=bool(
            params_model.get("connect_input_to_layers", True)),
        nonnegative=bool(params_model.get("nonnegative", True)),
        return_all_hidden=bool(params_model.get("return_all_hidden", False)),
        dropout_W=float(params_model.get("dropout_W", 0.0)),
        dropout_U=float(params_model.get("dropout_U", 0.0)),
        matmul_precision=params_model.get("matmul_precision", "default"),
        fold_frozen_U=bool(params_model.get("fold_frozen_U", True)),
        factored_S=bool(params_model.get("factored_S", True)),
        remat=bool(params_model.get("remat", True)),
        remat_policy=params_model.get("remat_policy", "auto"),
        scan_unroll=int(params_model.get("scan_unroll", 4)),
        batched_grad=bool(params_model.get("batched_grad", False)),
    )


def run_unfolded_snmf(params_model, params_data, folder_exp, path_dicts=None,
                      flag_recompute=False, flag_score=True,
                      compute_pesq=True, verbose=True,
                      splits=("valid", "test"), flag_rescore=False,
                      mesh=None):
    """The 'unfolded_snmf' branch of the reference driver
    (enhance.py:933-1236).  ``mesh``: optional jax Mesh with a 'dp' axis --
    training batches shard over it (gradients psum across devices)."""
    ensure_experiment_dirs(folder_exp)
    if path_dicts is None:
        path_dicts = os.path.join(folder_exp, "dicts") + "/"
        os.makedirs(path_dicts, exist_ok=True)

    datasets = build_datasets(params_data)
    w_noisy, params_snmf = _dict_from_config(
        params_model, params_data, datasets, folder_exp, path_dicts,
        flag_recompute, verbose,
    )

    input_dim = int(params_data["params_stft"]["N"]) // 2 + 1
    config = drnmf_config_from_params(
        params_model, input_dim,
        mask_value=get_mask_value(
            params_data.get("transform_x", "mag"),
            params_data.get("transform_y", "mag"),
        ),
    )
    params = init_drnmf_params(config, w_noisy)

    # 'resume' is run control, not model identity -- keep it out of the hash
    h = config_hash(params_model, exclude=("resume", "fsdp"))
    dump_yaml(params_model,
              os.path.join(folder_exp, "configs", f"params_unfolded_snmf_{h}.yaml"))
    savefile = os.path.join(folder_exp, "models", f"model_unfolded_snmf_{h}.npz")
    histfile = os.path.join(folder_exp, "history", f"history_unfolded_snmf_{h}")

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    use_dropout = config.dropout_W > 0 or config.dropout_U > 0

    # 2-D dp x tp mesh (cli --tp): train through the tensor-sharded forward
    # (drnmf_apply_tp_dp -- batch over dp, hidden contraction over tp).
    # Exact (parity-tested), so checkpoints/scores are mesh-independent.
    tp_sharded = mesh is not None and int(dict(mesh.shape).get("tp", 1)) > 1
    if tp_sharded:
        if use_dropout:
            raise NotImplementedError(
                "--tp training does not support dropout_W/dropout_U "
                "(the tp scan implements the plain cell only)")
        from .models.drnmf import step_mask_from_input
        from .parallel import drnmf_apply_tp_dp

        def loss_fn(p, x, y, mask):  # noqa: F811 -- tp-sharded override
            sm = step_mask_from_input(x, config.mask_value)
            irm = drnmf_apply_tp_dp(p, config, x, sm, mesh)
            return masked_mse_signal_approx(irm, x, y, mask)

    def train_loss_fn(p, x, y, mask, rng):
        irm = drnmf_apply(p, config, x, rng=rng, training=True)
        return masked_mse_signal_approx(irm, x, y, mask)

    pretrain = bool(params_model.get("pretrain_with_snmf_cost", False))
    savefile_pretrain = savefile.replace(".npz", "_pretrain.npz")
    resume = bool(params_model.get("resume", False))
    need_train = flag_recompute or not os.path.exists(savefile)
    if resume and not need_train:
        # a best checkpoint exists, but the interrupted run may still have
        # epochs to go -- the train-state file knows
        from .train.loop import train_state_incomplete

        need_train = train_state_incomplete(
            savefile, int(params_model.get("epochs", 100)),
            int(params_model.get("patience", 50)),
        )
    need_pretrain = pretrain and (
        flag_recompute or not os.path.exists(savefile_pretrain)
    )

    if need_train or need_pretrain:
        maxlen = params_data.get("maxlen", 500)
        train_data = load_tensors(
            datasets["train"], params_data, maxlen,
            cache_path=os.path.join(
                folder_exp,
                f"tensors_train_ds{params_data.get('downsample', 1)}"
                f"_maxlen{maxlen}.npz",
            ),
        )
        valid_data = load_tensors(
            datasets["valid"], params_data, maxlen,
            cache_path=os.path.join(folder_exp, f"tensors_valid_maxlen{maxlen}.npz"),
        )
        tc = TrainConfig(
            epochs=int(params_model.get("epochs", 100)),
            batch_size=int(params_model.get("batch_size", 32)),
            learning_rate=float(params_model.get("learning_rate", 1e-3)),
            clipnorm=float(params_model.get("clipnorm", 0.0)),
            decay=float(params_model.get("decay", 0.0)),
            patience=int(params_model.get("patience", 50)),
            seed=int(params_model.get("seed", 7654)),
            verbose=verbose,
        )

    if pretrain:
        # SNMF-cost pretraining (enhance.py:1024-1120): minimize the unfolded
        # network's own sparse-coding objective 0.5*MSE(clean+noise, x) +
        # lam1*(2r/F)*L1(h), best-val checkpointed, then warm-start the
        # signal-approximation training from those weights.
        lam1 = float(params_model["lam1"])

        def pretrain_loss_fn(p, x, y, mask):
            _, hidden, clean_est, noise_est = drnmf_apply(
                p, config, x, return_parts=True
            )
            return snmf_pretrain_loss(clean_est, noise_est, hidden, x, mask, lam1)

        if need_pretrain:
            if verbose:
                print("Pretraining with the SNMF cost...")
            train_model(
                params, pretrain_loss_fn, train_data, valid_data, tc,
                trainable_mask=drnmf_trainable_mask(config, params),
                savefile=savefile_pretrain, histfile=histfile + "_pretrain",
                mesh=mesh, fsdp=bool(params_model.get("fsdp", False)),
            )
        pre_params, _ = load_checkpoint(savefile_pretrain)
        params = {k: np.asarray(v) for k, v in pre_params.items()}
        config = ensure_fold_valid(config, params, verbose=verbose)

    if need_train:
        if "savefile_init" in params_model:
            init_params, _ = load_checkpoint(params_model["savefile_init"])
            params = {k: np.asarray(v) for k, v in init_params.items()}
            config = ensure_fold_valid(config, params, verbose=verbose)
        best_params, _ = train_model(
            params,
            train_loss_fn if use_dropout else loss_fn,
            train_data, valid_data, tc,
            trainable_mask=drnmf_trainable_mask(config, params),
            savefile=savefile, histfile=histfile,
            eval_loss_fn=loss_fn if use_dropout else None,
            loss_takes_rng=use_dropout,
            resume=resume,
            mesh=mesh, fsdp=bool(params_model.get("fsdp", False)),
        )
    else:
        best_params, _ = load_checkpoint(savefile)
        best_params = {k: np.asarray(v) for k, v in best_params.items()}
    config = ensure_fold_valid(config, best_params, verbose=verbose)

    results = {}
    if flag_score:
        for split in splits:
            if verbose:
                print(f"Scoring {split} set...")
            timer = StageTimer()
            audio_s = dataset_audio_seconds(datasets[split])
            with timer.stage("load_tensors"):
                x, y, mask = load_tensors(
                    datasets[split], params_data, None,
                    cache_path=os.path.join(folder_exp, f"tensors_{split}_full.npz"),
                )
            with timer.stage("predict_irm", audio_seconds=audio_s):
                irm = predict_irm(
                    lambda p, xb: drnmf_apply(p, config, xb), best_params, x,
                    mask_value=config.mask_value,
                )
            desc = f"unfolded_snmf_{h}_{split}"
            with timer.stage("reconstruct", audio_seconds=audio_s):
                reconstruct_split(datasets[split], irm, mask, desc)
            results[split] = score_split(
                datasets[split], desc, folder_exp + "/",
                compute_pesq=compute_pesq, verbose=verbose,
                flag_rescore=flag_rescore, mesh=mesh,
            )
            if verbose:
                print(f"Enhancement timing ({split}):\n{timer.report()}")
    return best_params, config, results


def run_lstm(params_model, params_data, folder_exp, flag_recompute=False,
             flag_score=True, compute_pesq=True, verbose=True,
             splits=("valid", "test"), flag_rescore=False, mesh=None):
    """The 'lstm' branch (enhance.py:1239-1388)."""
    ensure_experiment_dirs(folder_exp)
    datasets = build_datasets(params_data)
    input_dim = int(params_data["params_stft"]["N"]) // 2 + 1
    config = LSTMConfig(
        input_dim=input_dim,
        hidden_dim=int(params_model["hidden_dim"]),
        output_dim=input_dim,
        K_layers=int(params_model["K_layers"]),
        mask_value=get_mask_value(
            params_data.get("transform_x", "mag"),
            params_data.get("transform_y", "mag"),
        ),
        scan_unroll=int(params_model.get("scan_unroll", 4)),
    )
    params = init_lstm_params(config)

    h = config_hash(params_model, exclude=("resume", "fsdp"))
    dump_yaml(params_model,
              os.path.join(folder_exp, "configs", f"params_lstm_{h}.yaml"))
    savefile = os.path.join(folder_exp, "models", f"model_lstm_{h}.npz")
    histfile = os.path.join(folder_exp, "history", f"history_lstm_{h}")

    def loss_fn(p, x, y, mask):
        irm = lstm_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    resume = bool(params_model.get("resume", False))
    need_train = flag_recompute or not os.path.exists(savefile)
    if resume and not need_train:
        from .train.loop import train_state_incomplete

        need_train = train_state_incomplete(
            savefile, int(params_model.get("epochs", 100)),
            int(params_model.get("patience", 50)),
        )
    if need_train:
        maxlen = params_data.get("maxlen", 500)
        train_data = load_tensors(
            datasets["train"], params_data, maxlen,
            cache_path=os.path.join(
                folder_exp,
                f"tensors_train_ds{params_data.get('downsample', 1)}"
                f"_maxlen{maxlen}.npz",
            ),
        )
        valid_data = load_tensors(
            datasets["valid"], params_data, maxlen,
            cache_path=os.path.join(folder_exp, f"tensors_valid_maxlen{maxlen}.npz"),
        )
        tc = TrainConfig(
            epochs=int(params_model.get("epochs", 100)),
            batch_size=int(params_model.get("batch_size", 32)),
            learning_rate=float(params_model.get("learning_rate", 1e-4)),
            clipnorm=float(params_model.get("clipnorm", 1.0)),
            patience=int(params_model.get("patience", 50)),
            seed=int(params_model.get("seed", 7654)),
            verbose=verbose,
        )
        best_params, _ = train_model(
            params, loss_fn, train_data, valid_data, tc,
            savefile=savefile, histfile=histfile,
            resume=resume, mesh=mesh,
            fsdp=bool(params_model.get("fsdp", False)),
        )
    else:
        best_params, _ = load_checkpoint(savefile)
        best_params = {k: np.asarray(v) for k, v in best_params.items()}

    results = {}
    if flag_score:
        for split in splits:
            x, y, mask = load_tensors(
                datasets[split], params_data, None,
                cache_path=os.path.join(folder_exp, f"tensors_{split}_full.npz"),
            )
            irm = predict_irm(
                lambda p, xb: lstm_apply(p, config, xb), best_params, x,
                mask_value=config.mask_value,
            )
            desc = f"lstm_{h}_{split}"
            reconstruct_split(datasets[split], irm, mask, desc)
            results[split] = score_split(
                datasets[split], desc, folder_exp + "/",
                compute_pesq=compute_pesq, verbose=verbose,
                flag_rescore=flag_rescore, mesh=mesh,
            )
    return best_params, config, results


def run_snmf(params_model, params_data, folder_exp, path_dicts=None,
             flag_recompute=False, flag_score=True, compute_pesq=True,
             verbose=True, splits=("valid", "test"), flag_rescore=False,
             mesh=None):
    """The 'snmf' branch (enhance.py:750-928): dictionary + frozen-W MU
    inference as the enhancer.  ``mesh``: optional jax Mesh -- scoring
    shards bucket rows over its first axis (identical scores)."""
    ensure_experiment_dirs(folder_exp)
    if path_dicts is None:
        path_dicts = os.path.join(folder_exp, "dicts") + "/"
        os.makedirs(path_dicts, exist_ok=True)

    datasets = build_datasets(params_data)
    w_noisy, params_snmf = _dict_from_config(
        params_model, params_data, datasets, folder_exp, path_dicts,
        flag_recompute, verbose,
    )
    h = config_hash(params_model)
    dump_yaml(params_model,
              os.path.join(folder_exp, "configs", f"params_snmf_{h}.yaml"))
    histfile = os.path.join(folder_exp, "history", f"history_snmf_{h}")

    results = {}
    if flag_score:
        for split in splits:
            x, y, mask = load_tensors(
                datasets[split], params_data, None,
                cache_path=os.path.join(folder_exp, f"tensors_{split}_full.npz"),
            )
            x_frames = masked_seqs_to_frames(x, mask)
            irm_frames, _ = snmf_infer_irm(
                x_frames, w_noisy, params_snmf,
                max_iter=int(params_model.get("infer_max_iter", 200)),
            )
            if split == "valid":
                y_frames = masked_seqs_to_frames(y, mask)
                val_loss = float(np.mean((irm_frames * x_frames - y_frames) ** 2))
                with open(histfile, "wb") as f:
                    pickle.dump({"on_epoch_end": {"val_loss": [val_loss]}}, f)
                if verbose:
                    print(f"SNMF signal-approximation val_loss: {val_loss:.6f}")
            desc = f"snmf_{h}_{split}"
            ds = datasets[split]
            # route through the bucketed batch reconstruction
            # (reconstruct_split) instead of a per-utterance Python loop --
            # the thousands-of-tiny-dispatches pattern it was built to
            # kill.  The padded (B, T, F) irm tensor is the
            # same shape as the split's x tensor (maxlen=None: one row per
            # file), filled from the frame stack by fidx range.
            timer = StageTimer()
            audio_s = dataset_audio_seconds(ds)
            irm = np.zeros_like(x)
            for j in range(len(ds.x_wavfiles)):
                ln = int(ds.fidx[j, 1] - ds.fidx[j, 0])
                irm[j, :ln] = irm_frames[:, ds.fidx[j, 0]: ds.fidx[j, 1]].T
            with timer.stage("reconstruct", audio_seconds=audio_s):
                reconstruct_split(ds, irm, mask, desc)
            if verbose:
                print(f"Enhancement timing ({split}):\n{timer.report()}")
            results[split] = score_split(
                ds, desc, folder_exp + "/",
                compute_pesq=compute_pesq, verbose=verbose,
                flag_rescore=flag_rescore, mesh=mesh,
            )
    return w_noisy, params_snmf, results

#!/usr/bin/env python
"""Full-scale shakeout: one CHiME2-scale epoch, measured.

Every published full-scale number so far was steps/s x iteration-count
extrapolation; the largest corpus ever run end-to-end here was 48 files
(~3 min of audio).  This script generates a synthetic corpus at the
reference's actual training scale -- 7,138 train utterances
(taskfile_chime2_train_noisy.txt line count) with a WSJ0-like length
distribution (~14 h of audio) -- then runs the production pipeline stage
by stage on the device, measuring wall-clock and peak host RSS per stage:

  1. corpus     wav synthesis + writes (host)
  2. featurize  AudioDataset device STFT featurizer + HDF5 cache
  3. tensorize  maxlen-500 chunking -> (n_seq, 500, 257) tensors + npz
  4. train      ONE epoch of the flagship DR-NMF (B=32) through the
                production loop, from a random unit-L2 dictionary of
                the production shape (identical FLOPs to a trained one)
  5. enhance    predict+reconstruct a 240-file valid split (RTF)
  6. snmf       two-stage dictionary (r=1000) through the chunked MU
                driver (the snmf.py:33-36 frame_batch_size regime) --
                LAST because it is the open-ended stage; its iteration
                count shrinks (floor min(50, cap)) when the session
                deadline leaves less than a full solve needs

Each stage is cached/idempotent, so an interrupted run resumes.  Results
append to runs/scale_r5/shakeout.json.

Usage:
  python scripts/scale_shakeout.py [--files 7138] [--valid-files 240]
      [--r 1000] [--snmf-max-iter 1000] [--epochs 1] [--skip STAGES]
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# scale-keyed workdir: every cached stage artifact (corpus, HDF5 stacks,
# tensors, dictionaries, model state) is only valid for ONE corpus size --
# a smoke run must never seed the full-scale measurement
WORKDIR = os.path.join(REPO, "runs", "scale_r5")


def _rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--files", type=int, default=7138)
    ap.add_argument("--valid-files", type=int, default=240)
    ap.add_argument("--r", type=int, default=1000)
    ap.add_argument("--snmf-max-iter", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--skip", default="",
                    help="comma list of skippable stage names: train, "
                         "enhance, snmf (corpus/featurize/tensorize are "
                         "cache-idempotent and always run -- later stages "
                         "need their outputs)")
    args = ap.parse_args()
    skip = set(s for s in args.skip.split(",") if s)
    unknown = skip - {"train", "enhance", "snmf"}
    if unknown:
        ap.error(f"--skip: not skippable: {sorted(unknown)} "
                 "(only train, enhance, snmf)")

    global WORKDIR
    # scale key: every knob that changes a cached artifact is in the dir
    # name; defaults collapse to the historical files<N>_r<R> path so
    # existing measurements stay resumable
    key = f"files{args.files}_r{args.r}"
    for flag, short in (("valid_files", "v"), ("epochs", "e"),
                        ("batch_size", "b")):
        val = getattr(args, flag)
        if val != ap.get_default(flag):
            key += f"_{short}{val}"
    WORKDIR = os.path.join(WORKDIR, key)
    os.makedirs(WORKDIR, exist_ok=True)
    report_path = os.path.join(WORKDIR, "shakeout.json")
    report = {"files": args.files, "stages": {}}
    if os.path.exists(report_path):
        # resume: keep the measurements of already-completed stages -- a
        # re-entered stage that cache-hits must not overwrite the genuine
        # wall-clock with its near-zero replay time
        with open(report_path) as f:
            prev = json.load(f)
        report.update(prev)
        report["stages"] = prev.get("stages", {})

    def stage(name):
        class _T:
            def __enter__(self):
                self.t0 = time.monotonic()
                report["stages"].setdefault(name, {})
                print(f"[shakeout] == {name} ==", flush=True)
                return self

            def __exit__(self, et, ev, tb):
                wall = time.monotonic() - self.t0
                cur = report["stages"][name]
                if et is not None:
                    # crashed/interrupted attempt: its wall is NOT the
                    # stage measurement (the resumed completion is) --
                    # record it separately and let the exception propagate
                    cur["failed_attempt_s"] = round(wall, 1)
                elif wall >= cur.get("wall_s", 0.0):
                    cur.update({"wall_s": round(wall, 1),
                                "rss_gb": round(_rss_gb(), 2)})
                else:  # cache replay of a stage measured for real before
                    cur["cached_rerun_s"] = round(wall, 1)
                print(f"[shakeout] {name}: {wall:.1f}s "
                      f"(peak RSS {_rss_gb():.1f} GB)", flush=True)
                with open(report_path, "w") as f:
                    json.dump(report, f, indent=1)
                return False
        return _T()

    import jax

    import bench

    bench._enable_compile_cache()
    devs = jax.devices()
    report["device"] = devs[0].device_kind
    print(f"[shakeout] backend: {devs[0].device_kind}", flush=True)

    from drnmf_tpu.data.synthetic import make_synthetic_corpus, \
        wsj0_like_lengths

    # ---- 1. corpus --------------------------------------------------------
    tf = {}
    with stage("corpus"):
        for split, n, seed in (("train", args.files, 2016),
                               ("valid", args.valid_files, 77)):
            root = os.path.join(WORKDIR, f"audio_{split}")
            tfn = os.path.join(root, "taskfile_noisy.txt")
            tfc = os.path.join(root, "taskfile_clean.txt")
            if not (os.path.exists(tfn) and os.path.exists(tfc)):
                rng = np.random.default_rng(seed)
                make_synthetic_corpus(
                    root, n_files=n, seed=seed,
                    lengths=wsj0_like_lengths(rng, n),
                    verbose_every=500)
            tf[split] = (tfn, tfc)
        secs = 0.0
        for split in ("train", "valid"):
            import wave

            for p in open(tf[split][0]).read().split():
                with wave.open(p) as w:
                    secs += w.getnframes() / w.getframerate()
        report["audio_hours"] = round(secs / 3600.0, 2)
        print(f"[shakeout] corpus: {report['audio_hours']} h", flush=True)

    params_data = {
        "downsample": 1, "maxlen": 500,
        "params_stft": {"N": 512, "hop": 128, "nch": 1},
        "transform_x": "mag", "transform_y": "mag",
        "taskfile_x_train": tf["train"][0], "taskfile_y_train": tf["train"][1],
        "taskfile_x_valid": tf["valid"][0], "taskfile_y_valid": tf["valid"][1],
        "datafile_train": os.path.join(WORKDIR, "stfts_train.h5"),
        "datafile_valid": os.path.join(WORKDIR, "stfts_valid.h5"),
    }

    # ---- 2. featurize ------------------------------------------------------
    from drnmf_tpu.pipeline import (build_datasets, dataset_audio_seconds,
                                    load_tensors)

    with stage("featurize"):
        datasets = build_datasets(params_data, splits=("train", "valid"))
        d_tr = datasets["train"]
        report["stages"]["featurize"].update({
            "n_files": int(d_tr.fidx.shape[0]),
            "total_frames": int(np.sum(d_tr.fidx[:, 1] - d_tr.fidx[:, 0])),
            "audio_s": round(dataset_audio_seconds(d_tr), 1),
            "stack_gb": round(d_tr.x_stack.nbytes / 1e9, 2),
        })

    # ---- 3. tensorize ------------------------------------------------------
    with stage("tensorize"):
        xt, yt, mt = load_tensors(
            datasets["train"], params_data, 500,
            cache_path=os.path.join(WORKDIR, "tensors_train.npz"))
        xv, yv, mv = load_tensors(
            datasets["valid"], params_data, 500,
            cache_path=os.path.join(WORKDIR, "tensors_valid.npz"))
        n_seq = xt.shape[0]
        iters = int(np.ceil(n_seq / args.batch_size))
        report["stages"]["tensorize"].update({
            "n_seq": int(n_seq), "tensor_gb":
                round(sum(t.nbytes for t in (xt, yt, mt)) / 1e9, 2),
            "iters_per_epoch": iters,
        })
        print(f"[shakeout] {n_seq} seqs -> {iters} iters/epoch at "
              f"B={args.batch_size}", flush=True)

    # ---- 4. train one epoch -----------------------------------------------
    # Runs BEFORE the dictionary stage, from a RANDOM unit-L2 dictionary of
    # the production shape: the stage measures THROUGHPUT (wall/epoch,
    # steps/s) and every FLOP is identical to a trained-dictionary run --
    # while the r=1000 dictionary solve at 6M+ frames can absorb the
    # session's remaining budget, so it goes last (stage 6).
    # Model config + init params are built regardless of --skip train so
    # the enhance stage can run standalone (it reloads the checkpoint).
    from drnmf_tpu.models import (drnmf_apply, drnmf_trainable_mask,
                                  init_drnmf_params)
    from drnmf_tpu.pipeline import drnmf_config_from_params

    rng = np.random.default_rng(7654)
    w_noisy = rng.uniform(
        0.01, 1.0, (257, 2 * args.r)).astype(np.float32)
    w_noisy /= np.sqrt(np.sum(w_noisy**2, axis=0))
    config = drnmf_config_from_params(
        {"K_layers": 5, "r": args.r, "alph": 400.0, "lam1": 1.0,
         "params_untied": ["log_D", "log_alph"],
         "params_trainable": ["log_D", "log_alph"]}, 257)
    params = init_drnmf_params(config, np.asarray(w_noisy))
    savefile = os.path.join(WORKDIR, "model_scale.npz")

    if "train" not in skip:
        from drnmf_tpu.train import (TrainConfig, masked_mse_signal_approx,
                                     train_model)

        def loss_fn(p, x, y, mask):
            irm = drnmf_apply(p, config, x)
            return masked_mse_signal_approx(irm, x, y, mask)

        with stage("train"):
            tc = TrainConfig(epochs=args.epochs,
                             batch_size=args.batch_size,
                             learning_rate=1e-3, patience=50, verbose=True)
            t0 = time.monotonic()
            params, hist = train_model(
                params, loss_fn, (xt, yt, mt), (xv, yv, mv), tc,
                trainable_mask=drnmf_trainable_mask(config, params),
                savefile=savefile, resume=True)
            wall = time.monotonic() - t0
            st = report["stages"]["train"]
            if wall >= st.get("wall_s", 0.0):
                # a resumed cache-replay (near-zero wall because the epochs
                # already ran) must not overwrite the genuine throughput
                st.update({
                    "epochs": args.epochs,
                    "steps_per_s": round(iters * args.epochs / wall, 2),
                    "epoch_s": round(wall / args.epochs, 1),
                    "final_loss":
                        float(hist.history["on_epoch_end"]["loss"][-1]),
                })

    # ---- 5. enhance the valid split ----------------------------------------
    if "enhance" not in skip:
        from drnmf_tpu.pipeline import predict_irm, reconstruct_split

        if "train" in skip and os.path.exists(savefile):
            from drnmf_tpu.train.checkpoint import load_checkpoint

            params, _ = load_checkpoint(savefile)

        with stage("enhance"):
            audio_s = dataset_audio_seconds(datasets["valid"])
            # inference uses per-utterance full-length rows (maxlen=None),
            # exactly like run_unfolded_snmf's scoring path -- the
            # maxlen-500 training tensors are per-CHUNK rows and cannot be
            # fed to reconstruct_split (one row per wav file required).
            # Featurize/cache-write happens BEFORE the RTF timer so the
            # number matches bench.py's enhance definition (predict +
            # reconstruct only).
            xf, _, mf = load_tensors(
                datasets["valid"], params_data, None,
                cache_path=os.path.join(WORKDIR, "tensors_valid_full.npz"))
            t0 = time.monotonic()
            irm = predict_irm(
                lambda p, x: drnmf_apply(p, config, x), params, xf,
                mask_value=config.mask_value)
            reconstruct_split(datasets["valid"], irm, mf, "scale_shakeout")
            wall = time.monotonic() - t0
            # predict+reconstruct always run for real (only the featurize
            # npz is cached), so no replay guard here
            report["stages"]["enhance"].update({
                "audio_s": round(audio_s, 1),
                "predict_reconstruct_s": round(wall, 1),
                "rtf": round(audio_s / wall, 1),
            })

    # ---- 6. snmf dictionary at scale (LAST: the open-ended stage) ----------
    # the snmf.py:33-36 chunked-MU regime at the reference's true frame
    # count.  Budget-adaptive: if the session deadline
    # (DRNMF_TRAIN_DEADLINE_TS) leaves less than a full-iteration solve
    # needs, the iteration count shrinks (floor 50) so the 45-chunk
    # two-stage recipe is still exercised end-to-end and the measurement
    # reports which count ran.
    if "snmf" not in skip:
        from drnmf_tpu.data.batching import masked_seqs_to_frames
        from drnmf_tpu.ops import SNMFParams
        from drnmf_tpu.train.snmf_recipe import train_snmf

        max_iter = args.snmf_max_iter
        floor = min(50, args.snmf_max_iter)  # never exceed the user's cap
        deadline = float(os.environ.get("DRNMF_TRAIN_DEADLINE_TS", "0"))
        if deadline:
            left = deadline - time.time()
            # ~18.5 s per 1000-iter 140k-frame chunk solve (bench_snmf),
            # two recipe stages over n_frames/140k chunks
            n_chunks = max(1, int(np.ceil(
                np.sum(mt > 0) / 140_000.0))) * 2
            full_est = n_chunks * 18.5 * (max_iter / 1000.0)
            if left < full_est:
                # even past the deadline, run AT THE FLOOR: the point of
                # the stage is exercising the chunked recipe at scale, and
                # a skipped stage measures nothing
                max_iter = int(max(floor, min(
                    max_iter, (max(left, 0.0) / max(full_est, 1e-9))
                    * max_iter)))
                print(f"[shakeout] snmf: budget {left:.0f}s < est "
                      f"{full_est:.0f}s at {args.snmf_max_iter} iters -> "
                      f"max_iter {max_iter}", flush=True)
        params_snmf = SNMFParams(r=args.r, cf="ed", sparsity=1.0,
                                 max_iter=max_iter, conv_eps=1e-4,
                                 random_seed=2016)
        with stage("snmf"):
            x_frames = masked_seqs_to_frames(xt, mt)
            y_frames = masked_seqs_to_frames(yt, mt)
            st = report["stages"]["snmf"]
            st.update({"n_frames": int(x_frames.shape[1]), "r": args.r})
            if "wall_s" not in st:  # first REAL run labels the wall-clock
                st["max_iter"] = max_iter
            else:  # dict-cache replay must not relabel the measurement
                st["rerun_max_iter"] = max_iter
            train_snmf(
                y_frames, x_frames, params_snmf,
                path_dicts=os.path.join(WORKDIR, "dicts") + "/",
                verbose=True)
            del x_frames, y_frames

    print(json.dumps(report, indent=1), flush=True)
    print(f"[shakeout] report -> {report_path}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Batch-size scaling study: does the high-throughput regime reach the
parity schedule's quality?

Trains the SAME grid model (DR-NMF K=5, r=100) on the same corpus and the
same SNMF dictionary at the reference's parity batch (32, lr 1e-3 --
enhance.py:616-655) and at the framework's high-throughput batch (256, lr
scaled), N seeds per arm (the seed varies ONLY the training shuffle order
-- dictionary and init are deterministic -- so cross-seed spread is
exactly the training-stochasticity noise floor the round-3 one-run STOI
gap must be judged against), then scores every run on the same eval set
and prints a per-arm mean +- std summary.

Usage:
    python scripts/batch_scaling_study.py -d params_data.yaml \\
        [--epochs 300] [--seeds 7654,1234,9999] \\
        [--arms 32:1e-3,256:3e-3] [--exp-dir data_setup_bscale]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--data-config", required=True)
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--exp-dir", default="data_setup_bscale")
    parser.add_argument("--arms", default="32:1e-3,256:3e-3",
                        help="comma list of batch:lr arms (B=256 default "
                        "lr is ~sqrt(8)x the parity 1e-3)")
    parser.add_argument("--seeds", default="7654,1234,9999",
                        help="comma list of training shuffle seeds per arm")
    parser.add_argument("--no-pesq", action="store_true")
    args = parser.parse_args()

    from drnmf_tpu import pipeline
    from drnmf_tpu.reporting import best_val_loss
    from drnmf_tpu.utils import (config_hash, dump_yaml, enable_compile_cache,
                                 load_yaml)

    enable_compile_cache()
    arms = []
    for spec in args.arms.split(","):
        b, lr = spec.split(":")
        arms.append((int(b), float(lr)))
    seeds = [int(s) for s in args.seeds.split(",")]

    base = {
        "K_layers": 5,
        "r": 100,
        "alph": 50.0,
        "lam1": 1.0,
        "clipnorm": 0.0,
        "loss": "mse_of_masked",
        "optimizer": "adam",
        "params_trainable": ["log_D", "log_alph"],
        "params_untied": ["log_D", "log_alph"],
        "patience": 10**6,  # fixed-epoch comparison: no early stop
        "snmf_max_iter": 200,
        "snmf_conv_eps": 1e-4,
        "epochs": args.epochs,
        "resume": True,
    }
    params_data = load_yaml(args.data_config)
    os.makedirs(os.path.join(args.exp_dir, "configs"), exist_ok=True)

    rows = []  # (batch, lr, seed, val_loss, overall (6,))
    for bsz, lr in arms:
        for seed in seeds:
            cfg = dict(base, batch_size=bsz, learning_rate=lr, seed=seed)
            if seed == 7654:
                # the TrainConfig default: omit the key so the hash (and
                # artifact cache) matches the round-3 single-seed runs
                del cfg["seed"]
            h = config_hash(cfg, exclude=("resume",))
            path = os.path.join(args.exp_dir, "configs",
                                f"params_unfolded_snmf_{h}.yaml")
            dump_yaml(cfg, path)
            print(f"== batch {bsz} lr {lr} seed {seed}: {path}", flush=True)
            t0 = time.time()
            _, _, results = pipeline.run_unfolded_snmf(
                cfg, params_data, args.exp_dir, splits=("valid",),
                compute_pesq=not args.no_pesq)
            overall, _ = results["valid"]
            hist_path = os.path.join(args.exp_dir, "history",
                                     f"history_unfolded_snmf_{h}")
            val_loss = float("nan")
            if os.path.exists(hist_path):
                # BEST val loss, not the last epoch's: the checkpoint that
                # was scored for SDR/STOI is the best-val model, and the
                # same column print_scores reports (reporting.py)
                val_loss = best_val_loss(hist_path)
            rows.append((bsz, lr, seed, val_loss, overall.ravel()))
            print(f"== batch {bsz} seed {seed} wall: "
                  f"{time.time() - t0:.1f}s  val_loss {val_loss:.5f}  "
                  f"SDR {overall.ravel()[0]:.3f}  "
                  f"STOI {overall.ravel()[5]:.3f}", flush=True)

    # per-arm aggregation: mean +- std over seeds
    labels = ["SDR", "SNR", "SegSNRloc", "SegSNRglo", "PESQ", "STOI"]
    print("\n== seeded summary (mean +- std over seeds)")
    summary = []
    for bsz, lr in arms:
        sel = np.stack([r[4] for r in rows if r[0] == bsz and r[1] == lr])
        vls = np.array([r[3] for r in rows if r[0] == bsz and r[1] == lr])
        entry = {"batch": bsz, "lr": lr, "n_seeds": len(sel),
                 "val_loss_mean": round(float(np.nanmean(vls)), 5),
                 "val_loss_std": round(float(np.nanstd(vls)), 5)}
        for j, lab in enumerate(labels):
            entry[lab + "_mean"] = round(float(sel[:, j].mean()), 4)
            entry[lab + "_std"] = round(float(sel[:, j].std()), 4)
        summary.append(entry)
        print(json.dumps(entry), flush=True)

    if len(summary) >= 2:
        a, b = summary[0], summary[1]
        gap = b["STOI_mean"] - a["STOI_mean"]
        noise = max(a["STOI_std"], b["STOI_std"])
        print(json.dumps({
            "metric": "bscale_stoi_gap",
            "stoi_gap_arm1_minus_arm0": round(gap, 4),
            "max_seed_std": round(noise, 4),
            "systematic": bool(abs(gap) > 2.0 * max(noise, 1e-9)),
        }), flush=True)


if __name__ == "__main__":
    main()

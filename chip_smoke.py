#!/usr/bin/env python
"""End-to-end check of DR-NMF on an NVIDIA GPU.

    python chip_smoke.py             # phases 1-6 on one card
    python chip_smoke.py --chips 4   # only the data-parallel path, 4 cards

Drives the flagship model (K=5 unfolded layers, r=1000 atoms per source so
2r=2000 hidden units, F=257 bins from a 512-point STFT at hop 128, 16 kHz)
with random weights from a fixed seed through the entry points a user
calls, and compares every phase with a reference: the float64 numpy
transcription in ``drnmf_tpu/reference.py``, or the same jitted program run
on JAX's CPU backend inside this process.

Output: one JSON line per phase with its sizes and every compared quantity
beside its tolerance, a line with the card's name and power limit as
``nvidia-smi`` reports them, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed comparison or any exception ends the run with a non-zero exit
before that line.  The script refuses to run unless JAX's first device is
a GPU.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

FS, N_FFT, HOP = 16000, 512, 128
SEED = 7654

# phase sizes: full model width everywhere, lengths and step counts cut so a
# cold run (compilation included) takes a few minutes
SNMF_ATOMS, SNMF_FRAMES, SNMF_ITERS = 2000, 20_000, 10
TRAIN_B, TRAIN_T, TRAIN_STEPS = 32, 500, 5
GRAD_B, GRAD_T = 4, 100
UTT_SECONDS, N_STREAMS, BLOCK_FRAMES = 2.0, 4, 16
CORPUS_FILES, CORPUS_SECONDS = 12, (1.0, 3.0)
CLI_SNMF_ITERS = 5
DP_SEQS, DP_T, DP_EPOCHS = 64, 100, 2


class PhaseFailed(Exception):
    """A phase's comparison failed; the run ends with exit code 1."""


class Phase:
    """Collects the comparisons of one phase and prints them as one line."""

    def __init__(self, name, **sizes):
        self.name, self.sizes, self.checks = name, sizes, []
        self.notes = {}
        self.t0 = time.perf_counter()

    def check(self, what, value, tol, why):
        """Record ``value <= tol`` (both floats) with the tolerance's
        reason."""
        value = float(value)
        self.checks.append({"what": what, "value": value, "tol": tol,
                            "ok": bool(np.isfinite(value) and value <= tol),
                            "why": why})

    def require(self, what, cond):
        self.checks.append({"what": what, "ok": bool(cond)})

    def done(self):
        ok = all(c["ok"] for c in self.checks)
        print(json.dumps({"phase": self.name, "ok": ok, "sizes": self.sizes,
                          **self.notes, "checks": self.checks,
                          "seconds": round(time.perf_counter() - self.t0, 1)}),
              flush=True)
        if not ok:
            raise PhaseFailed(self.name)


def rel_err(a, b):
    """Frobenius norm of a - b over that of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def sdr_db(est, ref):
    """Plain signal-to-distortion ratio, 10 log10(|ref|^2 / |ref - est|^2)."""
    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    return float(10.0 * np.log10(np.sum(ref**2) / np.sum((ref - est) ** 2)))


def f32_matmul_class():
    """Which arithmetic a float32 matmul at default precision ran in,
    judged from its error against float64: TF32 keeps 10 mantissa bits
    (relative error near 1e-3 on a 512-deep product), full float32 keeps 23
    (near 1e-6)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 256)).astype(np.float32)
    err = rel_err(np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b))),
                  a.astype(np.float64) @ b.astype(np.float64))
    kind = "tf32" if err > 1e-5 else "float32"
    return kind, err


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def make_corpus(root):
    """Synthetic noisy/clean corpus (data/synthetic.py) with lengths spread
    evenly over CORPUS_SECONDS; returns its taskfiles."""
    from drnmf_tpu.data import make_synthetic_corpus

    lengths = np.linspace(*CORPUS_SECONDS, CORPUS_FILES)
    return make_synthetic_corpus(os.path.join(root, "audio"),
                                 n_files=CORPUS_FILES, seed=SEED,
                                 lengths=lengths)


def utterances(taskfiles, n):
    """The ``n`` longest noisy/clean pairs of the corpus, cut to
    UTT_SECONDS: (noisy (n, L), clean (n, L)) float32."""
    from drnmf_tpu.dsp import wavread

    def read(name):
        with open(taskfiles[name]) as f:
            return [wavread(p.strip())[0] for p in f if p.strip()]

    noisy, clean = read("noisy"), read("clean")
    order = np.argsort([-len(x) for x in noisy])[:n]
    L = int(UTT_SECONDS * FS)
    if any(len(noisy[i]) < L for i in order):
        raise RuntimeError(f"fewer than {n} corpus files reach {L} samples")
    return (np.stack([noisy[i][:L] for i in order]),
            np.stack([clean[i][:L] for i in order]))


def corpus_features(taskfiles):
    """Noisy and clean STFT magnitudes of every corpus file, concatenated
    along time: (frames, F) float32 each."""
    import jax.numpy as jnp

    from drnmf_tpu.dsp import stft, wavread

    def mags(name):
        with open(taskfiles[name]) as f:
            paths = [p.strip() for p in f if p.strip()]
        return np.concatenate([np.abs(np.asarray(stft(
            jnp.asarray(wavread(p)[0]), N_FFT, HOP))) for p in paths])

    return mags("noisy"), mags("clean")


def windows(feats, b, t, rng):
    """``b`` windows of ``t`` consecutive frames at random offsets (wrapping
    around the corpus): x noisy, y clean magnitudes (b, t, F), mask (b, t)."""
    x_all, y_all = feats
    idx = (rng.integers(0, len(x_all), b)[:, None] + np.arange(t)[None, :]
           ) % len(x_all)
    return (x_all[idx].astype(np.float32), y_all[idx].astype(np.float32),
            np.ones((b, t), np.float32))


def enhance_batch(enhance, params, signals):
    """Run a ``make_enhancer`` program on equal-length signals and undo its
    edge pads: (B, L) -> (B, L)."""
    import jax.numpy as jnp

    from drnmf_tpu.dsp.stft import pad_signal

    L = signals.shape[1]
    out = np.asarray(enhance(params, pad_signal(jnp.asarray(signals),
                                                N_FFT, HOP)))
    return out[:, N_FFT : N_FFT + L]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_snmf():
    """Sparse NMF dictionary learning (ops/snmf.py) against the float64
    transcription of the MU updates, from one initialization."""
    import jax

    from drnmf_tpu.ops import SNMFParams, sparse_nmf
    from drnmf_tpu.reference import numpy_sparse_nmf

    ph = Phase("snmf_dictionary", F=257, atoms=SNMF_ATOMS,
               frames=SNMF_FRAMES, iters=SNMF_ITERS, beta=2, sparsity=1.0)
    rng = np.random.default_rng(SEED)
    w_true = rng.gamma(1.0, 1.0, (257, 64))
    h_true = rng.gamma(0.3, 1.0, (64, SNMF_FRAMES))
    v = (w_true @ h_true + 0.01 * rng.uniform(size=(257, SNMF_FRAMES))
         ).astype(np.float32)
    w0 = rng.uniform(0.01, 1.0, (257, SNMF_ATOMS)).astype(np.float32)
    h0 = rng.uniform(0.01, 1.0, (SNMF_ATOMS, SNMF_FRAMES)).astype(np.float32)
    params = SNMFParams(r=SNMF_ATOMS, cf="ed", sparsity=1.0,
                        max_iter=SNMF_ITERS, init_w=w0, init_h=h0)
    w_ref, h_ref, _, cost_ref = numpy_sparse_nmf(v, w0, h0, 2.0, 1.0,
                                                 SNMF_ITERS)
    with jax.default_matmul_precision("highest"):
        hi = sparse_nmf(v, params)
    lo = sparse_nmf(v, params)
    why_hi = ("float32 against float64: rounding of sums over 20k frames, "
              "compounded over the iterations")
    why_lo = ("TF32 matmul inputs keep 10 mantissa bits; multiplicative "
              "updates compound that over the iterations")
    for tag, res, tol, why in (("highest", hi, 1e-5, why_hi),
                               ("default", lo, 1e-3, why_lo)):
        ph.check(f"W_rel_err_{tag}", rel_err(res.w, w_ref), tol, why)
        ph.check(f"H_rel_err_{tag}", rel_err(res.h, h_ref), tol, why)
        ph.check(f"cost_rel_err_{tag}",
                 abs(res.cost[-1] - cost_ref[-1]) / cost_ref[-1], tol, why)
    ph.done()


def phase_train(config, params, feats):
    """Adam steps of the training program (train/loop.py) on one fixed
    batch of corpus frames, and one gradient compared with the CPU
    backend."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.models import drnmf_apply, drnmf_trainable_mask
    from drnmf_tpu.train import (TrainConfig, make_optimizer,
                                 masked_mse_signal_approx)
    from drnmf_tpu.train.loop import make_train_step

    ph = Phase("train", B=TRAIN_B, T=TRAIN_T, steps=TRAIN_STEPS,
               grad_B=GRAD_B, grad_T=GRAD_T, K=config.K_layers,
               hidden=config.hidden_dim, F=config.input_dim,
               remat_policy=config.remat_policy,
               scan_unroll=config.scan_unroll)

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    rng = np.random.default_rng(SEED)
    opt = make_optimizer(TrainConfig(learning_rate=1e-3),
                         drnmf_trainable_mask(config, params))
    p = {k: jnp.array(v, copy=True) for k, v in params.items()}
    opt_state = opt.init(p)
    step = make_train_step(loss_fn, opt)
    x, y, m = (jnp.asarray(a) for a in windows(feats, TRAIN_B, TRAIN_T, rng))
    losses = []
    for _ in range(TRAIN_STEPS):
        p, opt_state, loss = step(p, opt_state, x, y, m)
        losses.append(float(loss))
    ph.notes["losses"] = losses
    ph.require("losses_finite", np.all(np.isfinite(losses)))
    ph.require("loss_falls", losses[-1] < losses[0])

    xg, yg, mg = windows(feats, GRAD_B, GRAD_T, rng)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    with jax.default_matmul_precision("highest"):
        l_gpu, g_gpu = grad_fn(params, xg, yg, mg)
        cpu = jax.devices("cpu")[0]
        l_cpu, g_cpu = grad_fn(jax.device_put(params, cpu),
                               *jax.device_put((xg, yg, mg), cpu))
    # frozen U leaves get exact zeros on both backends and are skipped
    leaves = [k for k in g_cpu if np.any(np.asarray(g_cpu[k]) != 0)]
    flat = [np.ravel(np.asarray(t[k], np.float64)) for t in (g_gpu, g_cpu)
            for k in leaves]
    n = len(leaves)
    why = ("float32 on both backends; only the order of the sums over "
           "batch, time and the 2r/F contractions differs")
    ph.check("loss_rel_err_vs_cpu", abs(float(l_gpu) - float(l_cpu))
             / abs(float(l_cpu)), 1e-5, why)
    ph.check("grad_rel_err_vs_cpu",
             rel_err(np.concatenate(flat[:n]), np.concatenate(flat[n:])),
             1e-4, why)
    worst = max((rel_err(g_gpu[k], g_cpu[k]), k) for k in leaves)
    ph.check("grad_worst_leaf_rel_err_vs_cpu", worst[0], 3e-3,
             "a scalar leaf (one alph, lam1) sums B*T*2r terms that nearly "
             "cancel, which magnifies the float32 reordering")
    ph.notes["worst_grad_leaf"] = worst[1]
    ph.done()


def phase_enhance(config, params, noisy, clean):
    """Offline enhancement (enhance.py::make_enhancer) against the float64
    STFT -> dense recurrence -> mask -> iSTFT reference.  Returns the
    default-precision outputs for the scoring phase."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.dsp import sqrt_hann_periodic
    from drnmf_tpu.dsp.stft import pad_signal, stft_frames
    from drnmf_tpu.enhance import make_enhancer
    from drnmf_tpu.models import drnmf_apply
    from drnmf_tpu.reference import numpy_enhance

    ph = Phase("offline_enhance", utterances=len(noisy),
               seconds=UTT_SECONDS, K=config.K_layers,
               hidden=config.hidden_dim, F=config.input_dim,
               n_fft=N_FFT, hop=HOP)
    irm_ref, y_ref = numpy_enhance(params, config, noisy, N_FFT, HOP)
    window = jnp.asarray(sqrt_hann_periodic(N_FFT))
    padded = pad_signal(jnp.asarray(noisy), N_FFT, HOP)

    def run(cfg):
        mag = jnp.abs(stft_frames(padded, window, N_FFT, HOP))
        irm = np.asarray(drnmf_apply(params, cfg, mag))
        return irm, enhance_batch(make_enhancer(cfg, N_FFT, HOP), params,
                                  noisy)

    cfg_hi = dataclasses.replace(config, matmul_precision="highest")
    with jax.default_matmul_precision("highest"):
        irm_hi, y_hi = run(cfg_hi)
    peak = float(np.max(np.abs(y_ref)))
    why = ("float32 recurrence (factored S, folded U) against float64 "
           "dense: reassociation over K=5 layers and 2r=2000 sums")
    ph.check("mask_max_abs_err_highest", max_abs(irm_hi, irm_ref), 1e-4, why)
    ph.check("wave_max_abs_err_over_peak_highest",
             max_abs(y_hi, y_ref) / peak, 1e-5, why)

    irm_lo, y_lo = run(config)
    kind, probe_err = f32_matmul_class()
    ph.notes["default_precision_ran_as"] = kind
    ph.notes["f32_matmul_probe_rel_err"] = probe_err
    d_sdr = [sdr_db(y_lo[i], clean[i]) - sdr_db(y_ref[i], clean[i])
             for i in range(len(noisy))]
    ph.notes["mask_max_abs_err_default"] = max_abs(irm_lo, irm_ref)
    ph.notes["sdr_db_reference"] = [sdr_db(y_ref[i], clean[i])
                                    for i in range(len(noisy))]
    ph.check("sdr_abs_diff_db_default", max(abs(d) for d in d_sdr), 0.1,
             "the 0.1 dB SDR parity budget of BASELINE.md")
    ph.done()
    return y_lo


def _load_serve():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "serve.py")
    spec = importlib.util.spec_from_file_location("drnmf_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _client(port, signal, chunk, out, errors, c):
    """One streaming client: length-prefixed float32 chunks, then a flush.
    Sockets and numpy only."""
    def recv_exact(sock, n):
        buf = b""
        while len(buf) < n:
            part = sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("server closed mid-message")
            buf += part
        return buf

    def reply(sock):
        (m,) = struct.unpack("<i", recv_exact(sock, 4))
        return np.frombuffer(recv_exact(sock, 4 * m), dtype="<f4")

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
            got = []
            for i in range(0, len(signal), chunk):
                part = np.asarray(signal[i : i + chunk], np.float32)
                s.sendall(struct.pack("<i", part.size) + part.tobytes())
                got.append(reply(s))
            s.sendall(struct.pack("<i", 0))
            got.append(reply(s))
        out[c] = np.concatenate(got)
    except Exception as e:  # reported by the phase, which then fails
        errors.append((c, repr(e)))


def phase_serve(config, params, signals):
    """scripts/serve.py's event-loop server over a MultiStreamEnhancer on
    loopback; every client's stream must equal the offline enhancer."""
    from drnmf_tpu.enhance import make_enhancer
    from drnmf_tpu.streaming import MultiStreamEnhancer

    ph = Phase("streaming_server", streams=N_STREAMS,
               seconds=UTT_SECONDS, block_frames=BLOCK_FRAMES)
    serve = _load_serve()
    multi = MultiStreamEnhancer(params, config, N_STREAMS, n_fft=N_FFT,
                                hop=HOP, block_frames=BLOCK_FRAMES)
    multi.step(np.zeros((N_STREAMS, multi.block_samples), np.float32))
    multi.flush_stream(0, tail=np.zeros(HOP, np.float32))
    for i in range(1, N_STREAMS):
        multi.reset_stream(i)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(N_STREAMS)
    port = srv.getsockname()[1]
    server_errors = []

    def run_server():
        try:
            serve.serve_multi_selector(srv, multi, max_connections=N_STREAMS,
                                       timeout=120.0, verbose=False)
        except Exception as e:  # reported by the phase, which then fails
            server_errors.append(repr(e))

    th = threading.Thread(target=run_server, daemon=True)
    th.start()
    outs, errors = [None] * N_STREAMS, []
    chunks = (1000, 2048, 3333, 4096)
    clients = [threading.Thread(target=_client, args=(
        port, signals[c], chunks[c % len(chunks)], outs, errors, c))
        for c in range(N_STREAMS)]
    try:
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        th.join(timeout=300)
    finally:
        srv.close()
    ph.require("clients_finished", not any(t.is_alive() for t in clients))
    ph.require("server_finished", not th.is_alive())
    ph.notes["client_errors"] = errors
    ph.notes["server_errors"] = server_errors
    ph.require("no_errors", not errors and not server_errors)
    offline = enhance_batch(make_enhancer(config, N_FFT, HOP), params,
                            signals)
    worst = 0.0
    for c in range(N_STREAMS):
        got = outs[c]
        ph.require(f"stream_{c}_length", got is not None
                   and len(got) >= signals.shape[1])
        if got is not None and len(got) >= signals.shape[1]:
            worst = max(worst, max_abs(got[: signals.shape[1]], offline[c])
                        / float(np.max(np.abs(offline[c]))))
    ph.check("stream_vs_offline_max_abs_over_peak", worst, 3e-4,
             "the same cell at default precision (TF32) on both sides; the "
             "block-shaped programs round and sum in another order than the "
             "whole-utterance program")
    ph.done()


def phase_score(est, clean):
    """The device scoring engine (metrics/engine.py) against the same
    engine on the CPU backend."""
    import jax

    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.scoring import SCORE_LABELS

    ph = Phase("scoring", pairs=len(est), seconds=UTT_SECONDS)
    est = [np.asarray(e, np.float32) for e in est]
    refs = [np.asarray(c, np.float32) for c in clean]
    s_gpu, d_gpu = score_all_packed(est, refs, FS)
    with jax.default_device(jax.devices("cpu")[0]):
        s_cpu, d_cpu = score_all_packed(est, refs, FS)
    ph.notes["scores_gpu"] = dict(zip(SCORE_LABELS,
                                      np.mean(s_gpu, 0).tolist()))
    ph.require("delays_equal", np.array_equal(d_gpu, d_cpu))
    tols = {"SDR": 1e-3, "SNR": 1e-3, "SegSNR local": 1e-3,
            "SegSNR global": 1e-3, "PESQ": 1e-3, "STOI": 1e-4}
    why = ("float32 FFTs, matmuls and reductions in another order than on "
           "the CPU; dB and MOS scores move in the 5th digit, STOI in the "
           "6th")
    for j, label in enumerate(SCORE_LABELS):
        ph.check(f"{label}_max_abs_diff_vs_cpu",
                 max_abs(s_gpu[:, j], s_cpu[:, j]), tols[label], why)
    ph.done()


def phase_cli(config, root, taskfiles):
    """The command line end to end (cli.main) at the model's width on the
    synthetic corpus: dictionary, one epoch, enhancement, scoring."""
    import glob

    from drnmf_tpu import cli
    from drnmf_tpu.data.native_loader import native_available

    ph = Phase("cli", files=CORPUS_FILES, seconds=list(CORPUS_SECONDS),
               K_layers=config.K_layers, r=config.r, N=N_FFT, hop=HOP,
               epochs=1, snmf_max_iter=CLI_SNMF_ITERS)
    data = {
        "taskfile_x_train": taskfiles["noisy"],
        "taskfile_y_train": taskfiles["clean"],
        "taskfile_x_valid": taskfiles["noisy"],
        "taskfile_y_valid": taskfiles["clean"],
        "taskfile_x_test": taskfiles["noisy"],
        "taskfile_y_test": taskfiles["clean"],
        "transform_x": "mag", "transform_y": "mag",
        "params_stft": {"N": N_FFT, "hop": HOP, "nch": 1},
        "maxlen": 500, "downsample": 1,
    }
    model = {
        "K_layers": config.K_layers, "r": config.r, "alph": config.alph,
        "lam1": config.lam1,
        "epochs": 1, "batch_size": 32, "learning_rate": 1e-3,
        "clipnorm": 0.0, "patience": 50,
        "params_untied": ["log_D", "log_alph"],
        "params_trainable": ["log_D", "log_alph"],
        "snmf_max_iter": CLI_SNMF_ITERS, "snmf_conv_eps": 0.0,
    }
    # JSON is valid YAML: the configs load with or without PyYAML
    c_path = os.path.join(root, "params_unfolded_snmf_smoke.yaml")
    d_path = os.path.join(root, "params_data.yaml")
    for path, obj in ((c_path, model), (d_path, data)):
        with open(path, "w") as f:
            json.dump(obj, f)
    exp = os.path.join(root, "exp")
    cli.main(["-c", c_path, "-d", d_path, "--exp-dir", exp, "--dp", "1",
              "--splits", "valid", "-q"])
    wavs = glob.glob(os.path.join(root, "audio", "clean",
                                  "enhanced_unfolded_snmf_*_valid", "*",
                                  "*.wav"))
    hist = glob.glob(os.path.join(exp, "history", "history_unfolded_snmf_*"))
    scores = glob.glob(os.path.join(exp, "scores", "scores_*.npz"))
    ph.notes["wav_reader"] = "native" if native_available() else "scipy"
    ph.notes["enhanced_wavs"] = len(wavs)
    ph.require("enhanced_wavs", len(wavs) == CORPUS_FILES)
    ph.require("history", len(hist) >= 1)
    ph.require("scores", len(scores) >= 1)
    finite = all(np.all(np.isfinite(np.load(s)["S"])) for s in scores)
    ph.require("scores_finite", finite)
    ph.done()


def phase_dp(config, params, feats, n):
    """The multi-card path the CLI takes with ``--dp n``: data-parallel
    training (train/loop.py over parallel/mesh.py::make_mesh) and
    mesh-sharded scoring (metrics/sharded.py), each against one card."""
    import jax

    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.scoring import SCORE_LABELS
    from drnmf_tpu.metrics.sharded import score_all_sharded
    from drnmf_tpu.models import drnmf_apply, drnmf_trainable_mask
    from drnmf_tpu.parallel import make_mesh
    from drnmf_tpu.train import TrainConfig, masked_mse_signal_approx
    from drnmf_tpu.train import train_model

    ph = Phase("data_parallel", devices=n, seqs=DP_SEQS, T=DP_T,
               epochs=DP_EPOCHS, K=config.K_layers,
               hidden=config.hidden_dim, F=config.input_dim)
    mesh = make_mesh(n)
    rng = np.random.default_rng(SEED)
    train = windows(feats, DP_SEQS, DP_T, rng)
    valid = windows(feats, DP_SEQS // 4, DP_T, rng)

    def loss_fn(p, x, y, mask):
        return masked_mse_signal_approx(drnmf_apply(p, config, x), x, y,
                                        mask)

    tc = TrainConfig(epochs=DP_EPOCHS, batch_size=32, learning_rate=1e-3,
                     patience=50, verbose=False)
    tmask = drnmf_trainable_mask(config, params)
    best_1, hist_1 = train_model(params, loss_fn, train, valid, tc,
                                 trainable_mask=tmask)
    best_n, hist_n = train_model(params, loss_fn, train, valid, tc,
                                 trainable_mask=tmask, mesh=mesh)
    why = ("gradients summed across cards by NCCL in another order than "
           "one card's batch reduction; TF32 matmuls at default precision")
    loss_1 = np.asarray(hist_1.history["on_epoch_end"]["loss"])
    loss_n = np.asarray(hist_n.history["on_epoch_end"]["loss"])
    ph.notes["loss_one_card"] = loss_1.tolist()
    ph.notes["loss_mesh"] = loss_n.tolist()
    ph.check("epoch_loss_max_rel_diff",
             float(np.max(np.abs(loss_n - loss_1) / np.abs(loss_1))), 1e-3,
             why)
    ph.check("params_max_rel_err",
             max(rel_err(best_n[k], best_1[k]) for k in tmask if tmask[k]),
             1e-3, why)

    rng = np.random.default_rng(SEED + 1)
    refs, ests = [], []
    for i in range(2 * n + 3):  # an uneven split and padded rows
        m = int(FS * (1.0 + 0.25 * i))
        band = np.convolve(rng.standard_normal(m), np.ones(8) / 8.0,
                           mode="same").astype(np.float32)
        refs.append(band)
        ests.append(band + 0.1 * rng.standard_normal(m).astype(np.float32))
    s_one, d_one = score_all_packed(ests, refs, FS)
    s_mesh, d_mesh = score_all_sharded(ests, refs, mesh, fs=FS)
    ph.require("sharded_delays_equal", np.array_equal(d_mesh, d_one))
    why = "per-card batches pick other FFT and reduction orders"
    for j, label in enumerate(SCORE_LABELS):
        ph.check(f"sharded_{label}_max_abs_diff",
                 max_abs(s_mesh[:, j], s_one[:, j]),
                 1e-3 if label == "STOI" else 0.01, why)
    ph.done()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel training and "
                    "sharded scoring across four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: "
              f"{devices[0].platform}); nothing was run", file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 2

    from drnmf_tpu.models import flagship

    for line in card_lines():
        print(line, flush=True)
    config, params = flagship(SEED)
    print(json.dumps({"phase": "setup", "jax": jax.__version__,
                      "device_kind": devices[0].device_kind,
                      "devices": len(devices), "K": config.K_layers,
                      "hidden": config.hidden_dim, "F": config.input_dim}),
          flush=True)
    try:
        with tempfile.TemporaryDirectory(prefix="drnmf_smoke_") as root:
            taskfiles = make_corpus(root)
            feats = corpus_features(taskfiles)
            if args.chips == 4:
                phase_dp(config, params, feats, 4)
            else:
                phase_snmf()
                phase_train(config, params, feats)
                noisy, clean = utterances(taskfiles, N_STREAMS)
                y_lo = phase_enhance(config, params, noisy[:2], clean[:2])
                phase_serve(config, params, noisy)
                phase_score(y_lo, clean[:2])
                phase_cli(config, root, taskfiles)
    except PhaseFailed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

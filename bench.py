"""Benchmark: enhancement real-time factor per card (+ train / loop / score).

Runs the complete DR-NMF enhancement compute path -- STFT featurization,
K-layer unfolded-ISTA recurrence over time, Wiener-style ratio mask, masked
iSTFT reconstruction -- as one jit'd on-device program over a batch of
utterances, and reports audio-seconds processed per wall-second, on the
flagship model (DR-NMF K=5, hidden 2r=2000, F=257, 16 kHz, N=512/hop=128
STFT).

The DEFAULT run covers enhance RTF+MFU, train step+MFU, train LOOP steps/s
and scoring-engine RTF, printing one JSON line per stage as it completes
and ONE summary headline line LAST (value = enhance real-time factor,
secondary metrics as extra fields, the device it ran on).  A stage that
fails is recorded in the summary's ``failed_stages`` and the run exits
non-zero.  ``--only-enhance`` restores the single-metric run;
``--serve/--serve-tcp/--snmf`` add the longer optional benchmarks.  The run
refuses to start without a GPU.
"""

import json
import os
import sys
import time

import numpy as np


def _enable_compile_cache():
    from drnmf_tpu.utils import enable_compile_cache

    enable_compile_cache()


# Published dense peaks of one card at its full power limit, by the
# arithmetic a matmul runs in, and its memory bandwidth (NVIDIA H100 data
# sheet, SXM part: 989 TFLOP/s bf16, 495 TF32, 67 FP32 outside the tensor
# cores, 3.35 TB/s HBM3).  Keyed by jax's device_kind.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                              "fp32": 67e12, "hbm_bytes": 3.35e12},
}
# the arithmetic a float32 matmul runs in at each DRNMFConfig precision
_MATMUL_CLASS = {"default": "tf32", "highest": "fp32"}


def device_peaks(kind=None):
    """Peak table row for ``kind`` (default: the first device's
    device_kind); a device missing from the table is an error."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in _PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add a row to bench._PEAKS")
    return _PEAKS[kind]


def drnmf_forward_flops(config, batch, frames):
    """Model FLOPs (2 * MACs) of one DR-NMF forward pass over a (batch,
    frames, F) input: the K-layer scan's matmuls per timestep plus the
    two reconstruction heads (the FFTs are not counted).  When the frozen-U fold is active
    (``fold_frozen_U`` with untrainable U -- every shipped reference config)
    the K U matmuls do not execute and are not counted.

    Counted explicitly because XLA's HLO cost analysis does not multiply a
    ``lax.scan`` body by its trip count (it reports the per-step cost once,
    ~T times too low for this model)."""
    from drnmf_tpu.models.drnmf import u_is_foldable

    h = config.hidden_dim  # 2r
    f = config.input_dim
    k = config.K_layers
    folded = u_is_foldable(config)
    factored = config.factored_S
    # hidden @ S_k: dense (2r, 2r) matmul, or the factored identity-minus
    # -rank-F pair (two F-contraction matmuls, DESIGN 2c); in the factored
    # ISTA-residual form the x_t @ W_k matmul for layers k > 0 fuses into
    # the S factors (W_k IS the second factor), so only layer 0 pays it
    s_term = (2 * (2 * h * f) if factored else 2 * h * h)
    w_layers = 1 if (factored and config.connect_input_to_layers) else k
    per_frame = (
        (0 if folded else k * 2 * h * h)  # h_prev @ U_k (rank-1 when folded)
        + (k - 1) * s_term     # hidden_{k-1} @ S_k (+ fused input term)
        + w_layers * 2 * f * h  # x_t @ W_k
        + 2 * 2 * (h // 2) * f  # exp-dense clean/noise heads
    )
    return batch * frames * per_frame


def _mfu(model_flops, wall_seconds, precision="default"):
    """(model TFLOP/s, model FLOPs utilization) against the card's peak for
    the arithmetic the model's matmuls run in at ``precision``."""
    peak = device_peaks()[_MATMUL_CLASS[precision]]
    tflops = model_flops / wall_seconds / 1e12
    return round(tflops, 1), round(tflops * 1e12 / peak, 3)


def _flagship():
    """The flagship model every benchmark measures
    (``drnmf_tpu.models.flagship``), params on the device."""
    import jax

    from drnmf_tpu.models import flagship

    config, params = flagship()
    return config, jax.device_put(params)


def _device():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.dsp.stft import pad_signal
    from drnmf_tpu.enhance import make_enhancer

    fs = 16000
    n_fft, hop = 512, 128
    # 2048 s of audio per program: a batch wide enough to amortize the
    # recurrence's per-time-step kernel launches
    batch, seconds = 256, 8.0
    nsampl = int(fs * seconds)

    config, params_dev = _flagship()

    enhance_jit = make_enhancer(config, n_fft, hop)

    # the test signal is generated on the device: no host transfer in the
    # set-up
    key = jax.random.PRNGKey(0)
    wav_dev = pad_signal(
        0.1 * jax.random.normal(key, (batch, nsampl), jnp.float32), n_fft, hop
    )

    # warmup / compile
    jax.block_until_ready(enhance_jit(params_dev, wav_dev))

    # 3 independent timed repeats (5 dispatches each): the median and the
    # observed spread go INTO the artifact, so run-to-run variance is
    # visible next to the number
    n_iter, n_repeat = 5, 3
    walls = []
    for _ in range(n_repeat):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = enhance_jit(params_dev, wav_dev)
        jax.block_until_ready(out)
        walls.append((time.perf_counter() - t0) / n_iter)
    wall = float(np.median(walls))

    audio_seconds = batch * seconds
    rtf = audio_seconds / wall
    rtf_runs = [round(audio_seconds / w, 1) for w in walls]
    spread_pct = round(
        100.0 * (max(rtf_runs) - min(rtf_runs)) / rtf, 1
    )
    from drnmf_tpu.dsp.stft import n_frames_for_length

    n_frames = n_frames_for_length(nsampl, n_fft, hop)
    tflops, mfu = _mfu(drnmf_forward_flops(config, batch, n_frames), wall,
                       config.matmul_precision)
    res = {
        "metric": "drnmf_enhance_rtf_per_chip",
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "rtf_runs": rtf_runs,
        "rtf_spread_pct": spread_pct,
        "model_tflops_per_s": tflops,
        "mfu": mfu,
    }
    print(json.dumps(res), flush=True)
    return res


def bench_train():
    """Training-step throughput at the reference schedule (batch 32,
    maxlen 500, flagship K=5/2r=2000 model, Adam)."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.models import drnmf_apply, drnmf_trainable_mask
    from drnmf_tpu.train import TrainConfig, make_optimizer, masked_mse_signal_approx
    from drnmf_tpu.train.loop import make_train_step

    config, params = _flagship()

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    opt = make_optimizer(TrainConfig(learning_rate=1e-3),
                         drnmf_trainable_mask(config, params))
    opt_state = opt.init(params)
    step = make_train_step(loss_fn, opt)

    bsz, maxlen = 32, 500
    key = jax.random.PRNGKey(0)
    kx, ky = jax.random.split(key)
    x = jax.random.uniform(kx, (bsz, maxlen, 257), jnp.float32, 0.0, 2.0)
    y = jax.random.uniform(ky, (bsz, maxlen, 257), jnp.float32, 0.0, 1.0)
    mask = jnp.ones((bsz, maxlen), jnp.float32)

    params, opt_state, loss = step(params, opt_state, x, y, mask)
    jax.block_until_ready(loss)  # compile + first step

    n_iter = 10
    t0 = time.perf_counter()
    for _ in range(n_iter):
        params, opt_state, loss = step(params, opt_state, x, y, mask)
    jax.block_until_ready(loss)
    per_step = (time.perf_counter() - t0) / n_iter
    # standard training-FLOP convention: backward ~= 2x forward matmul work
    tflops, mfu = _mfu(3 * drnmf_forward_flops(config, bsz, maxlen),
                       per_step, config.matmul_precision)
    # reference scale: 17296 iterations/epoch at 100% data (BASELINE.md)
    res = {
        "metric": "drnmf_train_steps_per_second",
        "value": round(1.0 / per_step, 2),
        "unit": "steps_per_s",
        "epoch_seconds_full_chime2": round(per_step * 17296, 1),
        "model_tflops_per_s": tflops,
        "mfu": mfu,
    }
    print(json.dumps(res), flush=True)
    return res


def bench_loop(bsz=32, maxlen=500, n_steps=30):
    """Training LOOP throughput (host-side orchestration included):
    train_model's dispatch pattern over a synthetic epoch — (a) EPOCH
    FUSION (chunks of steps as one scan program over the device-resident
    split, incl. the per-step batch gather), (b) the device loss
    accumulator (per-step dispatch, one history fetch per epoch), (c)
    fetching float(loss) after every step."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.models import drnmf_apply, drnmf_trainable_mask
    from drnmf_tpu.train import (
        TrainConfig, make_optimizer, masked_mse_signal_approx)
    from drnmf_tpu.train.loop import make_epoch_chunk, make_train_step

    config, base_params = _flagship()

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    tmask = drnmf_trainable_mask(config, base_params)
    # batches generated on device: the loop's per-step overhead is what is
    # measured here, not host->device streaming
    key = jax.random.PRNGKey(0)
    kx, ky = jax.random.split(key)
    x = jax.random.uniform(kx, (bsz, maxlen, config.input_dim),
                           jnp.float32, 0.0, 2.0)
    y = jax.random.uniform(ky, (bsz, maxlen, config.input_dim),
                           jnp.float32, 0.0, 1.0)
    mask = jnp.ones((bsz, maxlen), jnp.float32)

    results = {}
    for mode in ("accumulate", "per_step_fetch"):
        opt = make_optimizer(TrainConfig(learning_rate=1e-3), tmask)
        params = jax.device_put({k: jnp.array(np.asarray(v), copy=True)
                                 for k, v in base_params.items()})
        opt_state = opt.init(params)
        acc = mode == "accumulate"
        step = make_train_step(loss_fn, opt, accumulate_loss=acc)
        loss_buf = jnp.zeros(n_steps, jnp.float32)

        def epoch(params, opt_state, loss_buf):
            losses = []
            for bi in range(n_steps):
                if acc:
                    params, opt_state, loss_buf = step(
                        params, opt_state, loss_buf, np.int32(bi), x, y, mask)
                else:
                    params, opt_state, loss = step(params, opt_state,
                                                   x, y, mask)
                    losses.append(float(loss))  # round-2: blocking fetch
            if acc:
                losses = [float(v) for v in np.asarray(loss_buf)[:n_steps]]
            return params, opt_state, loss_buf, losses

        # warmup/compile
        params, opt_state, loss_buf, _ = epoch(params, opt_state, loss_buf)
        jax.block_until_ready(params["log_D_0"])
        t0 = time.perf_counter()
        params, opt_state, loss_buf, losses = epoch(params, opt_state, loss_buf)
        jax.block_until_ready(params["log_D_0"])
        wall = time.perf_counter() - t0
        results[mode] = n_steps / wall

    # round-4 default: EPOCH FUSION — a whole chunk of steps as ONE scan
    # program gathering each batch from the device-resident split (the
    # fused arm pays the per-step gather the others don't)
    opt = make_optimizer(TrainConfig(learning_rate=1e-3), tmask)
    params = jax.device_put({k: jnp.array(np.asarray(v), copy=True)
                             for k, v in base_params.items()})
    opt_state = opt.init(params)
    chunk_fn = make_epoch_chunk(loss_fn, opt)
    idx = jnp.tile(jnp.arange(bsz, dtype=jnp.int32)[None, :], (n_steps, 1))

    def epoch_fused(params, opt_state):
        params, opt_state, losses = chunk_fn(
            params, opt_state, x, y, mask, idx, jnp.int32(0))
        _ = np.asarray(losses)  # the per-epoch history fetch
        return params, opt_state

    params, opt_state = epoch_fused(params, opt_state)  # compile
    jax.block_until_ready(params["log_D_0"])
    t0 = time.perf_counter()
    params, opt_state = epoch_fused(params, opt_state)
    jax.block_until_ready(params["log_D_0"])
    results["epoch_fuse"] = n_steps / (time.perf_counter() - t0)

    res = {
        "metric": "train_loop_steps_per_second",
        "value": round(results["epoch_fuse"], 2),
        "unit": "steps_per_s",
        "accumulate_steps_per_s": round(results["accumulate"], 2),
        "per_step_fetch_steps_per_s": round(results["per_step_fetch"], 2),
        "speedup_vs_per_step_fetch": round(
            results["epoch_fuse"] / results["per_step_fetch"], 3),
        "speedup_vs_accumulate": round(
            results["epoch_fuse"] / results["accumulate"], 3),
        "epoch_seconds_full_chime2": round(17296 / results["epoch_fuse"], 1),
    }
    print(json.dumps(res), flush=True)
    return res


def bench_serving():
    """Multi-stream serving steady state: aggregate real-time factor vs
    concurrent stream count for the flagship model (batching the per-block
    step across streams is the configuration that fills the card)."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.streaming import MultiStreamEnhancer

    fs, n_fft, hop = 16000, 512, 128
    config, params = _flagship()
    rng = np.random.default_rng(7654)

    rows = []
    for block in (16, 64):
        for n_streams in (1, 4, 16, 64):
            enh = MultiStreamEnhancer(params, config, n_streams,
                                      n_fft=n_fft, hop=hop,
                                      block_frames=block)
            blk = enh.block_samples
            chunk = 0.1 * rng.standard_normal(
                (n_streams, blk)).astype(np.float32)
            for _ in range(3):  # warm: compile + latency fill
                enh.step(chunk)
            n_iter = 20
            t0 = time.perf_counter()
            for _ in range(n_iter):
                out = enh.step(chunk)
            wall = (time.perf_counter() - t0) / n_iter
            audio_s = n_streams * blk / fs
            rows.append({
                "block_frames": block,
                "n_streams": n_streams,
                "aggregate_rtf": round(audio_s / wall, 1),
                "per_stream_rtf": round(audio_s / wall / n_streams, 2),
                "step_ms": round(wall * 1e3, 2),
                "latency_ms": round(1000.0 * ((block - 1) * hop + n_fft)
                                    / fs, 1),
            })
            del out
    best = max(rows, key=lambda r: r["aggregate_rtf"])
    print(json.dumps({
        "metric": "serving_aggregate_rtf",
        "value": best["aggregate_rtf"],
        "unit": "x_realtime",
        "best": best,
        "table": rows,
    }))


def bench_serve_tcp(configs=((16, 16), (64, 64))):
    """End-to-end TCP serving (scripts/serve.py --streams): S concurrent
    socket clients streaming full-speed through one batched
    MultiStreamEnhancer behind the EVENT-LOOP server (3 server threads
    total; ``--serve-tcp-threads`` measures the thread-per-reader server
    instead for the A/B).  Clients run in SEPARATE PROCESSES (8 client
    threads per process) so the measurement reflects a server host, not
    one Python process carrying 2S GIL-sharing threads.  Measures the
    SERVED aggregate real-time factor
    vs bench_serving's raw lockstep, then the production SLO view: S
    clients PACED at 1.0x real time, reporting per-chunk reply-latency
    percentiles and whether latency is stationary under full load."""
    threads = "--serve-tcp-threads" in sys.argv
    for streams, block_frames in configs:
        _bench_serve_tcp_one(streams, block_frames, use_threads=threads)
    _bench_serve_tcp_one(32, 16, paced=True, use_threads=threads)
    _bench_serve_tcp_one(64, 16, paced=True, use_threads=threads)
    _bench_serve_tcp_one(64, 64, paced=True, use_threads=threads)


def bench_paced_slo(configs=((32, 16), (64, 16), (64, 64))):
    """Paced SLO measured INSIDE the server process (``--paced-slo``):
    synthetic 1.0x-real-time clients with COMPUTED arrival schedules --
    no per-client OS processes, so clients that share the server's CPU
    cores cannot fall behind their own schedule and be read as a slow
    server.  The batching policy replicates the event-loop server's coordinator
    (gather window 0.25 blocks, one block per stream per step); what is
    NOT measured is socket IO, which the chip-free thread-vs-event-loop
    A/B (scripts/slo_stub_study.py) covers separately."""
    from drnmf_tpu.streaming import MultiStreamEnhancer, paced_load, \
        paced_stats

    fs, n_fft, hop = 16000, 512, 128
    config, params = _flagship()
    rows = []
    for streams, block_frames in configs:
        multi = MultiStreamEnhancer(params, config, streams, n_fft=n_fft,
                                    hop=hop, block_frames=block_frames)
        block_dur = multi.block_samples / fs
        lat, taken = paced_load(multi, seconds=20.0, fs=fs)
        st = paced_stats(lat, block_dur)
        st.update({"streams": streams, "block_frames": block_frames,
                   "block_ms": round(block_dur * 1e3, 1),
                   "latency_ms": round(1000.0 * ((block_frames - 1) * hop
                                                 + n_fft) / fs, 1),
                   "blocks_served": int(taken.sum())})
        rows.append(st)
        print(json.dumps({"metric": "paced_slo_internal", **st}),
              flush=True)
    ok = [r for r in rows if r["keeps_up"]]
    print(json.dumps({
        "metric": "paced_slo_internal_envelope",
        "value": max((r["streams"] for r in ok), default=0),
        "unit": "streams_stationary",
        "table": rows,
    }), flush=True)


def _tcp_client_proc(port, c0, n_clients, seed, n_samp, blk, paced, q):
    """Top-level multiprocessing (spawn) target: ``n_clients`` request-
    reply clients on threads.  Regenerates the test signal from ``seed``
    (cheaper than pickling it) and never imports jax.  Reports
    (t_start, t_end, [(client, received, latencies)]) through ``q``."""
    import socket
    import struct
    import threading

    fs = 16000
    rng = np.random.default_rng(seed)
    sig = (0.1 * rng.standard_normal(n_samp)).astype(np.float32)
    block_dur = blk / fs
    results = []
    lock = threading.Lock()

    def recv_exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed mid-message")
            buf += chunk
        return buf

    def client(c):
        """In paced mode each chunk is sent on the live-source schedule
        (one block per block duration) and the reply latency is measured
        against that schedule, so client-side drift from late replies
        shows up as latency rather than hiding in slowed-down sends."""
        sock = socket.create_connection(("127.0.0.1", port), timeout=300)
        got, lat = 0, []
        start = time.perf_counter()
        for k, i in enumerate(range(0, n_samp, blk)):
            if paced:
                sleep = start + k * block_dur - time.perf_counter()
                if sleep > 0:
                    time.sleep(sleep)
            part = sig[i : i + blk]
            sock.sendall(struct.pack("<i", part.size) + part.tobytes())
            (m,) = struct.unpack("<i", recv_exact(sock, 4))
            recv_exact(sock, 4 * m)
            if paced:
                lat.append(time.perf_counter() - (start + k * block_dur))
            got += m
        sock.sendall(struct.pack("<i", 0))
        (m,) = struct.unpack("<i", recv_exact(sock, 4))
        recv_exact(sock, 4 * m)
        sock.close()
        with lock:
            results.append((c, got + m, lat))

    t_start = time.time()
    ths = [threading.Thread(target=client, args=(c,))
           for c in range(c0, c0 + n_clients)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    q.put((t_start, time.time(), results))


def _bench_serve_tcp_one(S, block, paced=False, use_threads=False):
    import multiprocessing as mp
    import socket
    import sys as _sys
    import threading

    from drnmf_tpu.streaming import MultiStreamEnhancer

    _sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import serve

    fs, n_fft, hop = 16000, 512, 128
    seconds = 20.0
    config, params = _flagship()

    multi = MultiStreamEnhancer(params, config, S, n_fft=n_fft, hop=hop,
                                block_frames=block)
    blk = multi.block_samples
    # warm both device programs before timing (compile + latency fill)
    multi.step(np.zeros((S, blk), np.float32))
    multi.flush_stream(0, tail=np.zeros(hop, np.float32))
    for i in range(1, S):
        multi.reset_stream(i)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(S)
    port = srv.getsockname()[1]
    run = serve.serve_multi if use_threads else serve.serve_multi_selector
    th = threading.Thread(
        target=run, args=(srv, multi),
        kwargs=dict(max_connections=S, timeout=300.0, verbose=False),
        daemon=True)
    th.start()

    n_samp = int(seconds * fs)
    # clients in their own processes (spawn: fresh interpreters that never
    # touch jax) -- up to 8 client threads per process
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    procs, c0 = [], 0
    n_procs = max(1, (S + 7) // 8)
    for p in range(n_procs):
        n_c = min(8, S - c0)
        procs.append(ctx.Process(
            target=_tcp_client_proc,
            args=(port, c0, n_c, 7654, n_samp, blk, paced, q)))
        c0 += n_c
    for pr in procs:
        pr.start()
    received = np.zeros(S, np.int64)
    lat = [[] for _ in range(S)]
    t0s, t1s = [], []
    for _ in procs:
        t_start, t_end, results = q.get()
        t0s.append(t_start)
        t1s.append(t_end)
        for c, got, lv in results:
            received[c] = got
            lat[c] = lv
    for pr in procs:
        pr.join()
    th.join(timeout=60)
    # wall over the streaming span only (process spawn excluded)
    wall = max(t1s) - min(t0s)
    expect = (-(-n_samp // hop)) * hop
    assert all(r == expect for r in received), received
    audio_s = S * n_samp / fs
    server = "threads" if use_threads else "selector"
    block_dur = blk / fs
    if paced:
        all_lat = np.concatenate([np.asarray(v[1:]) for v in lat])  # drop
        # each stream's first chunk (includes connection rampup)
        p50, p95, p99 = np.percentile(all_lat, [50, 95, 99]) * 1000.0
        # keeping up == latency is STATIONARY over the run (a service rate
        # below demand shows as linear latency growth); the wall clock
        # also includes the end-of-run flush drains, so it can't be the
        # criterion.  Compare each stream's last-quarter mean latency to
        # its second-quarter mean.
        drifts = []
        for v in lat:
            a = np.asarray(v[1:])
            qq = len(a) // 4
            if qq >= 1:  # <5 chunks/stream: too short to estimate drift
                drifts.append(a[-qq:].mean() - a[qq : 2 * qq].mean())
        drift_ms = float(np.mean(drifts)) * 1000.0 if drifts else 0.0
        print(json.dumps({
            "metric": "served_tcp_paced_reply_latency_ms",
            "value": round(float(p95), 1),
            "unit": "ms_p95",
            "server": server,
            "p50_ms": round(float(p50), 1),
            "p99_ms": round(float(p99), 1),
            "max_ms": round(float(np.max(all_lat) * 1000.0), 1),
            "block_duration_ms": round(block_dur * 1000.0, 1),
            "streams": S,
            "block_frames": block,
            "latency_drift_ms": round(drift_ms, 1),
            "realtime_kept_up": bool(drift_ms < 0.25 * block_dur * 1000.0),
            "wall_s": round(wall, 2),
        }), flush=True)
        return
    print(json.dumps({
        "metric": "served_tcp_aggregate_rtf",
        "value": round(audio_s / wall, 1),
        "unit": "x_realtime",
        "server": server,
        "streams": S,
        "seconds_per_stream": seconds,
        "block_frames": block,
        "wall_s": round(wall, 2),
        "per_stream_rtf": round(audio_s / wall / S, 2),
    }), flush=True)


def bench_profile_train(bsz=32, maxlen=500, n_iter=20):
    """Stage attribution of the parity-schedule training step.  Times
    each component as its OWN jitted program at the parity schedule
    (B=32, T=500, flagship model): dispatch floor, the scan chain, the
    full forward (scan + heads + mask), the loss, value_and_grad, the
    Adam update, and the fused train step -- plus a T-scaling probe that
    splits the scan into per-step cost vs fixed overhead.  Derived rows:
    heads = forward - scan, backward = grad - loss, opt+fuse = step -
    grad - adam.  All numbers are wall of a blocking device round trip,
    so components add up to more than the fused step when XLA overlaps
    them -- the table bounds each stage's share, it does not pretend the
    stages serialize."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.models import drnmf_apply, drnmf_trainable_mask
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_tpu.train import (TrainConfig, make_optimizer,
                                 masked_mse_signal_approx)
    from drnmf_tpu.train.loop import make_train_step

    config, params = _flagship()
    f_dim = config.input_dim
    key = jax.random.PRNGKey(0)
    kx, ky = jax.random.split(key)
    x = jax.random.uniform(kx, (bsz, maxlen, f_dim), jnp.float32, 0.0, 2.0)
    y = jax.random.uniform(ky, (bsz, maxlen, f_dim), jnp.float32, 0.0, 1.0)
    mask = jnp.ones((bsz, maxlen), jnp.float32)
    sm = step_mask_from_input(x, config.mask_value)

    def loss_fn(p, x, y, mask):
        irm = drnmf_apply(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    opt = make_optimizer(TrainConfig(learning_rate=1e-3),
                         drnmf_trainable_mask(config, params))
    opt_state = opt.init(params)
    step = make_train_step(loss_fn, opt)

    def timeit(fn, *args, n=n_iter):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n * 1e3  # ms

    tiny = jnp.zeros(8, jnp.float32)
    prof = {}
    prof["dispatch_floor_ms"] = timeit(jax.jit(lambda a: a + 1.0), tiny,
                                       n=50)
    scan_j = jax.jit(lambda p, xx, s: _scan_hidden(p, config, xx, s))
    prof["scan_ms"] = timeit(scan_j, params, x, sm)
    fwd_j = jax.jit(lambda p, xx: drnmf_apply(p, config, xx))
    prof["forward_ms"] = timeit(fwd_j, params, x)
    loss_j = jax.jit(loss_fn)
    prof["loss_ms"] = timeit(loss_j, params, x, y, mask)
    grad_j = jax.jit(jax.value_and_grad(loss_fn))
    prof["grad_ms"] = timeit(grad_j, params, x, y, mask)
    _, g0 = grad_j(params, x, y, mask)

    def adam_only(g, p, s):
        upd, s2 = opt.update(g, s, p)
        import optax

        return optax.apply_updates(p, upd), s2

    prof["adam_ms"] = timeit(jax.jit(adam_only), g0, params, opt_state)

    # full fused step, steady-state chained updates (the step donates its
    # params/opt_state buffers, so time a chain on fresh copies)
    p_c = {k: jnp.array(np.asarray(v), copy=True) for k, v in params.items()}
    s_c = opt.init(p_c)
    p_c, s_c, l = step(p_c, s_c, x, y, mask)
    jax.block_until_ready(l)
    n = n_iter
    t0 = time.perf_counter()
    for _ in range(n):
        p_c, s_c, l = step(p_c, s_c, x, y, mask)
    jax.block_until_ready(l)
    prof["train_step_ms"] = (time.perf_counter() - t0) / n * 1e3

    # T-scaling probe: scan wall at T/4 separates per-step cost from
    # fixed overhead (dispatch + prologue)
    tq = maxlen // 4
    xq, smq = x[:, :tq], sm[:, :tq]
    prof["scan_Tquarter_ms"] = timeit(scan_j, params, xq, smq)
    per_step_us = ((prof["scan_ms"] - prof["scan_Tquarter_ms"])
                   / (maxlen - tq) * 1e3)
    prof["scan_per_timestep_us"] = round(per_step_us, 2)
    prof["scan_fixed_ms"] = round(
        prof["scan_Tquarter_ms"] - tq * per_step_us / 1e3, 3)

    # lever: scan unroll -- replicate the step body so XLA amortizes
    # per-iteration overhead (exact: same math, any T)
    import dataclasses

    for u in (2, 4, 8):
        cfg_u = dataclasses.replace(config, scan_unroll=u)

        def loss_u(p, xx, yy, mm, _c=cfg_u):
            irm = drnmf_apply(p, _c, xx)
            return masked_mse_signal_approx(irm, xx, yy, mm)

        step_u = make_train_step(loss_u, opt)
        p_u = {k: jnp.array(np.asarray(v), copy=True)
               for k, v in params.items()}
        s_u = opt.init(p_u)
        p_u, s_u, l = step_u(p_u, s_u, x, y, mask)
        jax.block_until_ready(l)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            p_u, s_u, l = step_u(p_u, s_u, x, y, mask)
        jax.block_until_ready(l)
        prof[f"train_step_unroll{u}_ms"] = (
            (time.perf_counter() - t0) / n_iter * 1e3)
        prof[f"scan_unroll{u}_ms"] = timeit(
            jax.jit(lambda p, xx, s, _c=cfg_u: _scan_hidden(p, _c, xx, s)),
            params, x, sm)

    # lever: rematerialization policy at the default unroll (the default
    # config resolves 'auto' -> store-all at this shape) -- 'full' replays
    # every step matmul in the backward; 'dots' saves dot outputs
    # (recomputes only elementwise); 'noremat' stores all residuals
    for name, kw in (("remat_full", dict(remat_policy="full")),
                     ("remat_dots", dict(remat_policy="dots")),
                     ("noremat", dict(remat=False))):
        cfg_r = dataclasses.replace(config, **kw)

        def loss_r(p, xx, yy, mm, _c=cfg_r):
            irm = drnmf_apply(p, _c, xx)
            return masked_mse_signal_approx(irm, xx, yy, mm)

        step_r = make_train_step(loss_r, opt)
        p_r = {k: jnp.array(np.asarray(v), copy=True)
               for k, v in params.items()}
        s_r = opt.init(p_r)
        try:
            p_r, s_r, l = step_r(p_r, s_r, x, y, mask)
            jax.block_until_ready(l)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                p_r, s_r, l = step_r(p_r, s_r, x, y, mask)
            jax.block_until_ready(l)
            prof[f"train_step_{name}_ms"] = (
                (time.perf_counter() - t0) / n_iter * 1e3)
        except Exception as e:  # e.g. OOM storing all residuals
            tail = str(e).splitlines()[-1][:120] if str(e) else ""
            prof[f"train_step_{name}_ms"] = (
                f"failed: {type(e).__name__}: {tail}")

    # attribution probe: grad w.r.t. the INPUT only -- XLA drops the
    # parameter-gradient accumulations, leaving the sequential delta chain
    # (+ forward).  grad_ms - this = the cost of accumulating weight grads
    # through the scan, the part the batched-T backward batches.
    prof["grad_wrt_x_ms"] = timeit(
        jax.jit(jax.grad(loss_fn, argnums=1)), params, x, y, mask)

    # lever: batched-T backward (models/batched_grad.py) -- sequential
    # delta chain only in the reverse scan, every weight gradient as ONE
    # T*B-contraction matmul
    for u in (1, config.scan_unroll):
        cfg_bg = dataclasses.replace(config, batched_grad=True,
                                     scan_unroll=u)

        def loss_bg(p, xx, yy, mm, _c=cfg_bg):
            irm = drnmf_apply(p, _c, xx)
            return masked_mse_signal_approx(irm, xx, yy, mm)

        step_bg = make_train_step(loss_bg, opt)
        p_b = {k: jnp.array(np.asarray(v), copy=True)
               for k, v in params.items()}
        s_b = opt.init(p_b)
        try:
            p_b, s_b, l = step_bg(p_b, s_b, x, y, mask)
            jax.block_until_ready(l)
            t0 = time.perf_counter()
            for _ in range(n_iter):
                p_b, s_b, l = step_bg(p_b, s_b, x, y, mask)
            jax.block_until_ready(l)
            prof[f"train_step_batched_grad_u{u}_ms"] = (
                (time.perf_counter() - t0) / n_iter * 1e3)
        except Exception as e:
            tail = str(e).splitlines()[-1][:120] if str(e) else ""
            prof[f"train_step_batched_grad_u{u}_ms"] = (
                f"failed: {type(e).__name__}: {tail}")

    prof = {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in prof.items()}
    derived = {
        "heads_mask_ms": round(prof["forward_ms"] - prof["scan_ms"], 3),
        "loss_term_ms": round(prof["loss_ms"] - prof["forward_ms"], 3),
        "backward_ms": round(prof["grad_ms"] - prof["loss_ms"], 3),
        "fuse_gain_ms": round(
            prof["grad_ms"] + prof["adam_ms"] - prof["train_step_ms"], 3),
    }
    print(json.dumps({
        "metric": "train_step_profile",
        "value": prof["train_step_ms"],
        "unit": "ms_per_step",
        **prof, **derived,
    }), flush=True)
    return prof


def bench_snmf():
    """Sparse NMF dictionary training at the reference's GPU-chunk scale:
    r=1000 (2r=2000 atoms), F=257, one full 140k-frame chunk
    (frame_batch_size = 700000*(200/r), snmf.py:33-36), beta=2, L1 sparsity,
    L2-normalized W columns -- the workload the reference ran in MATLAB
    gpuArray (sparse_nmf_gpu.m:188-298)."""
    import jax
    import jax.numpy as jnp

    from drnmf_tpu.ops import SNMFParams
    from drnmf_tpu.ops.snmf import sparse_nmf

    f_bins, r2 = 257, 2000
    n_frames = 140_000  # reference chunk size at r=1000
    key = jax.random.PRNGKey(0)
    v = jax.random.uniform(key, (f_bins, n_frames), jnp.float32, 0.01, 1.0)
    v.block_until_ready()

    n_iter = 50
    params = SNMFParams(r=r2, cf="ed", sparsity=1.0, max_iter=n_iter,
                        conv_eps=0.0, random_seed=2016)
    # device_output: H is (2000, 140k) = 1.1 GB -- fetching it would swamp
    # the measurement
    res = sparse_nmf(v, params, device_output=True)  # compile + run
    t0 = time.perf_counter()
    res = sparse_nmf(v, params, device_output=True)
    per_iter = (time.perf_counter() - t0) / n_iter

    print(json.dumps({
        "metric": "snmf_mu_iterations_per_second",
        "value": round(1.0 / per_iter, 2),
        "unit": "iters_per_s",
        "seconds_for_1000_iter_dictionary": round(per_iter * 1000, 1),
    }))


def bench_score():
    """Scoring-engine throughput: all six metrics (SDR, SNR, SegSNR x2,
    PESQ, STOI) over synthetic utterance pairs -- the stage the reference
    ran as a MATLAB parfor pool (score_audio.m:72-98).  Reports audio
    seconds scored per wall second for (a) the per-file thread-pool path
    and (b) the bucketed batched device path for SDR+SegSNR with
    PESQ/STOI/SNR on the host pool."""
    from drnmf_tpu.metrics.scoring import _score_pair
    from concurrent.futures import ThreadPoolExecutor

    fs = 16000
    rng = np.random.default_rng(7)
    n_files = 64
    pairs = []
    pairs_i16 = []
    audio_seconds = 0.0
    for i in range(n_files):
        n = int(fs * rng.uniform(2.0, 5.0))
        t = np.arange(n) / fs
        f0 = 120 + 40 * (i % 5)
        ref = (0.1 * np.sin(2 * np.pi * f0 * t)
               * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t))).astype(np.float32)
        est = ref + 0.02 * rng.standard_normal(n).astype(np.float32)
        # quantize to PCM16 like wav files (all paths see identical values;
        # the engine ships the int16 bytes and dequantizes on device)
        def q(x):
            return np.clip(np.round(x * 32768.0), -32768, 32767).astype(
                np.int16)

        est_i, ref_i = q(est), q(ref)
        pairs.append((est_i.astype(np.float32) / 32768.0,
                      ref_i.astype(np.float32) / 32768.0))
        pairs_i16.append((est_i, ref_i))
        audio_seconds += n / fs

    def per_file():
        def job(p):
            return _score_pair(p[0], p[1], fs)

        out = [job(pairs[0])]  # warm jit caches
        with ThreadPoolExecutor(max_workers=8) as pool:
            out.extend(pool.map(job, pairs[1:]))
        return np.stack(out)

    def packed():
        # device: packed-transfer fused SDR+SNR+SegSNR and packed STOI per
        # pow2 bucket; host pool overlapped: PESQ + STOI host stage
        from drnmf_tpu.metrics.fused import fused_metrics_packed
        from drnmf_tpu.metrics.pesq import pesq_16k
        from drnmf_tpu.metrics.stoi import stoi_packed

        ests = [p[0] for p in pairs]
        refs = [p[1] for p in pairs]

        with ThreadPoolExecutor(max_workers=8) as pool:
            pesq_futs = [pool.submit(pesq_16k, p[1], p[0], fs)
                         for p in pairs]
            fused_fut = pool.submit(fused_metrics_packed, ests, refs, fs)
            stoi_vals = stoi_packed(refs, ests, fs, pool=pool)
            dev = fused_fut.result()
            pesq_vals = [f.result() for f in pesq_futs]
        S = np.zeros((n_files, 6))
        S[:, :4] = dev
        S[:, 4] = pesq_vals
        S[:, 5] = stoi_vals
        return S

    def engine():
        # round-3 engine: ALL metrics on device, one shared packed int16
        # transfer per bucket (PESQ/STOI device ports + fused program)
        from drnmf_tpu.metrics.engine import score_all_packed

        ests = [p[0] for p in pairs_i16]
        refs = [p[1] for p in pairs_i16]
        S, _ = score_all_packed(ests, refs, fs)
        return S

    results = {}
    for name, fn in (("per_file", per_file), ("packed", packed),
                     ("engine", engine)):
        fn()  # warm compile caches
        t0 = time.perf_counter()
        S = fn()
        results[name] = (audio_seconds / (time.perf_counter() - t0), S)

    rtf_pf, S_pf = results["per_file"]
    rtf_b, S_b = results["packed"]
    rtf_e, S_e = results["engine"]
    agree = float(np.max(np.abs(S_pf - S_b)))
    agree_engine = float(np.max(np.abs(S_pf - S_e)))
    res = {
        "metric": "scoring_rtf_per_chip",
        "value": round(max(rtf_pf, rtf_b, rtf_e), 2),
        "unit": "x_realtime",
        "per_file_rtf": round(rtf_pf, 2),
        "packed_rtf": round(rtf_b, 2),
        "engine_rtf": round(rtf_e, 2),
        "max_abs_path_disagreement": round(agree, 4),
        "max_abs_engine_disagreement": round(agree_engine, 4),
    }
    print(json.dumps(res), flush=True)
    return res


def _run_default():
    """Enhance + train step + train loop + scoring engine, then ONE summary
    headline line LAST (a reader of the output's tail finds the whole
    story even if an intermediate stage's own line scrolled out).  A stage
    that raises is recorded in the summary and the remaining stages still
    run; any failure makes the run exit non-zero after the summary."""
    results, failures = {}, {}
    for name, fn in (("enhance", main), ("train", bench_train),
                     ("loop", bench_loop), ("score", bench_score)):
        t0 = time.perf_counter()
        try:
            results[name] = fn() or {}
        except SystemExit:
            raise
        except Exception as e:  # recorded below; the run then exits 1
            tail = str(e).splitlines()[-1][:160] if str(e) else ""
            failures[name] = f"{type(e).__name__}: {tail}"
            print(f"[bench] stage {name} FAILED: {failures[name]}",
                  file=sys.stderr, flush=True)
        print(f"[bench] stage {name}: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    enh = results.get("enhance", {})
    line = {
        "metric": "drnmf_enhance_rtf_per_chip",
        "value": enh.get("value"),
        "unit": "x_realtime",
        "rtf_runs": enh.get("rtf_runs"),
        "rtf_spread_pct": enh.get("rtf_spread_pct"),
        "mfu": enh.get("mfu"),
        "train_steps_per_s": results.get("train", {}).get("value"),
        "train_mfu": results.get("train", {}).get("mfu"),
        "loop_steps_per_s": results.get("loop", {}).get("value"),
        "scoring_engine_rtf": results.get("score", {}).get("engine_rtf"),
        "device": _device(),
    }
    if failures:
        line["failed_stages"] = failures
    print(json.dumps(line), flush=True)
    if failures:
        sys.exit(1)
    return line


def _require_gpu():
    """Measurements are card numbers only: without a GPU, stop."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX found no GPU (first device: {dev.platform})",
              file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    _enable_compile_cache()
    _require_gpu()
    _flags = [a for a in sys.argv[1:] if a.startswith("--")]
    _full = "--full" in sys.argv  # every stage in one process
    _headline = None
    if not _flags or (_full and "--only-enhance" not in sys.argv):
        _headline = _run_default()  # the full default suite
    else:
        main()  # flagged runs: headline first, then the requested extras
    if "--train" in sys.argv:
        bench_train()
    if "--loop" in sys.argv:
        bench_loop()
    if "--profile-train" in sys.argv or _full:
        bench_profile_train()
    if "--serve" in sys.argv or _full:
        bench_serving()
    if "--paced-slo" in sys.argv or _full:
        bench_paced_slo()
    if ("--serve-tcp" in sys.argv or "--serve-tcp-threads" in sys.argv
            or _full):
        bench_serve_tcp()
    if "--snmf" in sys.argv or _full:
        bench_snmf()
    if "--score" in sys.argv:
        bench_score()
    if _headline is not None and _full:
        # the tail parser reads the LAST JSON line: re-print the headline
        # after the extra stages
        print(json.dumps(_headline), flush=True)

"""Streaming (online) enhancement: feed audio chunks, get enhanced audio out.

The reference is strictly offline (whole-utterance STFT stacks, enhance.py
predict loops).  The DR-NMF recurrence is O(1)-state -- one (2r,) vector --
so the framework can serve *online* with bounded latency:

    enh = StreamingEnhancer(params, config)
    for chunk in microphone():          # arbitrary chunk sizes
        play(enh.process(chunk))
    play(enh.flush())

Exactness: the streamer reproduces the offline pipeline bit-for-bit (up to
f32 accumulation order) because it replays the same computation in blocks:

* the sample buffer is primed with ``n_fft`` zeros (the reference's leading
  edge pad, util.py:178-183), so streamed frames equal offline frames;
* each compiled step processes ``block_frames`` frames: window -> DFT ->
  magnitude -> DR-NMF scan carried from the previous block's state -> ratio
  mask -> inverse DFT -> overlap-add into a carried (n_fft,) accumulator;
* a frame's overlap-add contribution is final ``hop`` samples at a time, so
  each block emits ``block_frames*hop`` samples; the first ``n_fft`` emitted
  samples are skipped (the reference's edge trim, util.py:219-223);
* ``flush`` zero-pads to a whole block -- zero frames mask to zero spectra
  and contribute nothing to the overlap-add, so padding is harmless.

Latency: ``n_fft - hop`` samples of framing lookahead plus one block
(``block_frames * hop`` samples).  Lower ``block_frames`` for latency,
raise it for throughput (larger device batches).
"""

import jax
import jax.numpy as jnp
import numpy as np

from .dsp.windows import sqrt_hann_periodic
from .models.drnmf import (
    DRNMFConfig,
    _effective_matrices,
    _heads,
    _ratio_mask,
    make_cell_step,
)


def _make_block_step(config: DRNMFConfig, n_fft: int, hop: int):
    """jit'd: (params, frames (k, n_fft), h (2r,), acc (n_fft,)) ->
    (out (k*hop,), h', acc')."""
    window = jnp.asarray(sqrt_hann_periodic(n_fft))
    syn = window * jnp.float32(2.0 / (n_fft / hop))

    @jax.jit
    def step(params, frames, h, acc):
        U, S, W, b = _effective_matrices(params, config, fold_u=True, factor_s=True)
        spec = jnp.fft.rfft(frames * window, axis=-1)
        re, im = jnp.real(spec), jnp.imag(spec)
        mag = jnp.sqrt(re * re + im * im)  # (k, F)

        # shared inference cell: honors activation / connect_input /
        # matmul_precision exactly like the offline scan
        base_cell = make_cell_step(config, U, S, W, b)

        def cell(h_prev, x_t):
            hidden = base_cell(h_prev[None, :], x_t[None, :])[0]
            return hidden, hidden

        h_fin, hs = jax.lax.scan(cell, h, mag)  # hs: (k, 2r)
        clean_est, noise_est = _heads(params, config, hs)
        irm = _ratio_mask(clean_est, noise_est, config.transform_before_irm)

        xr = jnp.fft.irfft(jax.lax.complex(re * irm, im * irm), n=n_fft,
                           axis=-1)
        xr = xr * syn  # (k, n_fft)

        # overlap-add into the carried accumulator, emitting hop samples per
        # frame: acc covers sample positions [cursor, cursor + n_fft)
        def ola(carry, frame):
            carry = carry + frame
            out = carry[:hop]
            carry = jnp.concatenate([carry[hop:], jnp.zeros((hop,), jnp.float32)])
            return carry, out

        acc, outs = jax.lax.scan(ola, acc, xr)
        return outs.reshape(-1), h_fin, acc

    return step


def _make_block_step_multi(config: DRNMFConfig, n_fft: int, hop: int):
    """jit'd batched block step: (params, frames (S, k, n_fft), h (S, 2r),
    acc (S, n_fft), active (S,) bool) -> (out (S, k*hop), h', acc').  The S
    streams advance in lockstep through ONE device program: one dispatch
    per block for all streams instead of one per stream, and matmuls with
    S rows instead of one.  ``active`` gates the state update per row:
    every compute row is independent (row-wise matmuls, no cross-S
    mixing), so inactive
    rows keep their h/acc EXACTLY while active rows' outputs are
    bit-identical to an all-active step -- this is what lets an async
    multi-client server step whichever streams have a block queued without
    corrupting the ones that don't."""
    window = jnp.asarray(sqrt_hann_periodic(n_fft))
    syn = window * jnp.float32(2.0 / (n_fft / hop))

    @jax.jit
    def step(params, frames, h, acc, active):
        U, S, W, b = _effective_matrices(params, config, fold_u=True,
                                         factor_s=True)
        spec = jnp.fft.rfft(frames * window, axis=-1)  # (S, k, F)
        re, im = jnp.real(spec), jnp.imag(spec)
        mag = jnp.sqrt(re * re + im * im)  # (S, k, F)

        cell = make_cell_step(config, U, S, W, b)

        def scan_cell(h_prev, x_t):  # h: (S, 2r), x_t: (S, F)
            hidden = cell(h_prev, x_t)
            return hidden, hidden

        h_fin, hs = jax.lax.scan(scan_cell, h, jnp.swapaxes(mag, 0, 1))
        hs = jnp.swapaxes(hs, 0, 1)  # (S, k, 2r)
        clean_est, noise_est = _heads(params, config, hs)
        irm = _ratio_mask(clean_est, noise_est, config.transform_before_irm)

        xr = jnp.fft.irfft(jax.lax.complex(re * irm, im * irm), n=n_fft,
                           axis=-1)
        xr = xr * syn  # (S, k, n_fft)

        def ola(carry, frame):  # carry: (S, n_fft), frame: (S, n_fft)
            carry = carry + frame
            out = carry[:, :hop]
            carry = jnp.concatenate(
                [carry[:, hop:], jnp.zeros((carry.shape[0], hop), jnp.float32)],
                axis=1)
            return carry, out

        acc_new, outs = jax.lax.scan(ola, acc, jnp.swapaxes(xr, 0, 1))
        # outs: (k, S, hop) -> (S, k*hop)
        out = jnp.swapaxes(outs, 0, 1).reshape(acc.shape[0], -1)
        m = active[:, None]
        return (jnp.where(m, out, 0.0), jnp.where(m, h_fin, h),
                jnp.where(m, acc_new, acc))

    return step


class MultiStreamEnhancer:
    """Batched online enhancement of S independent streams in lockstep.

    Each stream has the exact semantics of :class:`StreamingEnhancer`
    (same edge pads, trims, carried state); the S per-block device
    dispatches collapse into one, so serving throughput scales with the
    batch instead of being dispatch-bound.  Each ``step`` consumes
    ``block_frames * hop`` samples from every ACTIVE stream (the
    ``active`` mask lets an async server step only the streams with a
    block queued; the rest keep their state exactly) and returns the
    per-stream samples that became final.  A finished stream is drained
    with :meth:`flush_stream` (the per-stream counterpart of
    :meth:`StreamingEnhancer.flush` -- any trailing partial block goes in
    its ``tail``), which also recycles the slot for a new stream.
    """

    def __init__(self, params, config: DRNMFConfig, n_streams: int,
                 n_fft: int = 512, hop: int = 128, block_frames: int = 16):
        if config.dropout_W or config.dropout_U:
            raise NotImplementedError(
                "streaming is an inference path; dropout configs are "
                "training-only")
        if config.nonnegative:
            h0 = jax.nn.softplus(params["log_h0"])
        else:
            h0 = params["h0"]
        self.params = params
        self.config = config
        self.n_streams = n_streams
        self.n_fft, self.hop, self.block = n_fft, hop, block_frames
        self._step = _make_block_step_multi(config, n_fft, hop)
        self._h0 = jnp.asarray(h0)
        self._h = jnp.broadcast_to(
            self._h0[None, :], (n_streams, self._h0.shape[0])
        ) + jnp.zeros((n_streams, 1), jnp.float32)
        self._acc = jnp.zeros((n_streams, n_fft), jnp.float32)
        # per-stream host state, exactly StreamingEnhancer.reset()'s
        self._buf = [np.zeros(n_fft, np.float32) for _ in range(n_streams)]
        self._skip = np.full(n_streams, n_fft, np.int64)
        self._n_in = np.zeros(n_streams, np.int64)
        self._emitted = np.zeros(n_streams, np.int64)
        self._single = None  # lazy single-stream program for flush_stream

    @property
    def block_samples(self) -> int:
        return self.block * self.hop

    def reset_stream(self, i: int):
        self._h = self._h.at[i].set(self._h0)
        self._acc = self._acc.at[i].set(0.0)
        self._buf[i] = np.zeros(self.n_fft, np.float32)
        self._skip[i] = self.n_fft
        self._n_in[i] = 0
        self._emitted[i] = 0

    def step(self, samples: np.ndarray, active=None):
        """samples: (S, block_frames*hop) new input per stream.  Returns a
        list of S arrays with each stream's enhanced samples that became
        final this step (shorter during the initial latency fill, exactly
        like StreamingEnhancer.process).

        ``active``: optional (S,) bool mask.  Inactive streams consume no
        input (their ``samples`` rows are ignored), keep their carried
        state EXACTLY, and get ``None`` in the returned list -- active
        rows' outputs are bit-identical to an all-active step.  This is
        the async-serving interface: step whichever streams have a full
        block queued without waiting on (or corrupting) the others."""
        return self.step_fetch(self.step_dispatch(samples, active))

    def step_dispatch(self, samples: np.ndarray, active=None):
        """First half of :meth:`step`: frame, dispatch the device program
        (JAX async -- returns immediately), and advance all host-side
        bookkeeping.  Returns an opaque handle for :meth:`step_fetch`.

        Splitting lets a serving coordinator overlap the device step with
        gathering the NEXT batch (the step's output shape is static, so
        every piece of bookkeeping is known before the values are).  State
        is advanced here: exactly one ``step_fetch`` per dispatch, in
        dispatch order."""
        S, n_fft, hop, k = self.n_streams, self.n_fft, self.hop, self.block
        if active is None:
            active = np.ones(S, bool)
        else:
            active = np.asarray(active, bool).reshape(S)
        samples = np.asarray(samples, np.float32).reshape(S, k * hop)
        need = (k - 1) * hop + n_fft
        idx = np.arange(k)[:, None] * hop + np.arange(n_fft)[None, :]
        frames = np.zeros((S, k, n_fft), np.float32)
        for s in range(S):
            if not active[s]:
                continue
            self._buf[s] = np.concatenate([self._buf[s], samples[s]])
            assert len(self._buf[s]) >= need
            frames[s] = self._buf[s][:need][idx]
            self._buf[s] = self._buf[s][k * hop:]
        out, self._h, self._acc = self._step(
            self.params, jnp.asarray(frames), self._h, self._acc,
            jnp.asarray(active))
        self._n_in += np.where(active, k * hop, 0)
        cuts = np.full(S, -1, np.int64)  # -1: inactive
        L = k * hop  # static per-stream output length
        for s in range(S):
            if not active[s]:
                continue
            cut = int(min(self._skip[s], L))
            self._skip[s] -= cut
            self._emitted[s] += L - cut
            cuts[s] = cut
        return out, cuts

    def step_fetch(self, handle):
        """Second half of :meth:`step`: block on the device result of a
        :meth:`step_dispatch` handle and return the per-stream finals
        list (``None`` for streams inactive in that dispatch)."""
        out, cuts = handle
        out = np.asarray(out)
        return [None if cuts[s] < 0 else out[s][cuts[s]:]
                for s in range(self.n_streams)]

    def flush_stream(self, i: int, tail=None) -> np.ndarray:
        """Drain stream ``i``: emit exactly what the offline pipeline would
        produce for its signal (``ceil(n/hop)*hop`` samples total, minus
        what :meth:`step` already returned for it), exactly like
        :meth:`StreamingEnhancer.flush`.  ``tail`` carries the stream's
        final partial block (``step`` only accepts whole blocks).  The slot
        is reset afterwards, ready for a new stream."""
        n_fft, hop, k = self.n_fft, self.hop, self.block
        if self._single is None:
            self._single = _make_block_step(self.config, n_fft, hop)
        buf = self._buf[i]
        n_in = int(self._n_in[i])
        if tail is not None:
            tail = np.asarray(tail, np.float32).reshape(-1)
            buf = np.concatenate([buf, tail])
            n_in += len(tail)
        target = (-(-n_in // hop)) * hop if n_in else 0
        h, acc = self._h[i], self._acc[i]
        skip, emitted = int(self._skip[i]), int(self._emitted[i])
        need = (k - 1) * hop + n_fft
        idx = np.arange(k)[:, None] * hop + np.arange(n_fft)[None, :]
        outs = []
        while emitted < target:
            buf = np.concatenate([buf, np.zeros(k * hop, np.float32)])
            while len(buf) >= need and emitted < target:
                out, h, acc = self._single(
                    self.params, jnp.asarray(buf[:need][idx]), h, acc)
                buf = buf[k * hop:]
                out = np.asarray(out)
                cut = min(skip, len(out))
                out, skip = out[cut:], skip - cut
                if out.size:
                    take = out[: target - emitted]
                    emitted += len(take)
                    outs.append(take)
        self.reset_stream(i)
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)


class StreamingEnhancer:
    """Stateful online enhancer over a trained DR-NMF model.

    ``process`` accepts float32 mono samples of any length and returns the
    enhanced samples that became final; ``flush`` drains the tail.  The
    concatenated output equals the offline mask-and-iSTFT pipeline on the
    same signal.
    """

    def __init__(self, params, config: DRNMFConfig, n_fft: int = 512,
                 hop: int = 128, block_frames: int = 64):
        if config.dropout_W or config.dropout_U:
            raise NotImplementedError(
                "streaming is an inference path; dropout configs are "
                "training-only"
            )
        if config.nonnegative:
            h0 = jax.nn.softplus(params["log_h0"])
        else:
            h0 = params["h0"]
        self.params = params
        self.config = config
        self.n_fft, self.hop, self.block = n_fft, hop, block_frames
        self._step = _make_block_step(config, n_fft, hop)
        self._h0 = jnp.asarray(h0)
        self.reset()

    def reset(self):
        n_fft = self.n_fft
        self._buf = np.zeros(n_fft, np.float32)  # leading edge pad
        self._h = self._h0
        self._acc = jnp.zeros((n_fft,), jnp.float32)
        self._to_skip = n_fft  # trailing counterpart of the edge pad trim
        self._n_in = 0
        self._emitted = 0
        self._finished = False

    @property
    def latency_samples(self) -> int:
        """Worst-case samples buffered before output emerges."""
        return (self.block - 1) * self.hop + self.n_fft

    def _run_blocks(self):
        n_fft, hop, k = self.n_fft, self.hop, self.block
        need = (k - 1) * hop + n_fft
        outs = []
        while len(self._buf) >= need:
            take = self._buf[:need]
            idx = np.arange(k)[:, None] * hop + np.arange(n_fft)[None, :]
            frames = jnp.asarray(take[idx])
            out, self._h, self._acc = self._step(
                self.params, frames, self._h, self._acc
            )
            self._buf = self._buf[k * hop:]
            out = np.asarray(out)
            if self._to_skip:
                cut = min(self._to_skip, len(out))
                out = out[cut:]
                self._to_skip -= cut
            if out.size:
                self._emitted += len(out)
                outs.append(out)
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)

    def process(self, samples) -> np.ndarray:
        if self._finished:
            raise RuntimeError("stream flushed; call reset() to reuse")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._n_in += len(samples)
        self._buf = np.concatenate([self._buf, samples])
        return self._run_blocks()

    def flush(self) -> np.ndarray:
        """Drain: emit exactly what the offline pipeline would produce for
        the signal seen so far (ceil(n/hop)*hop samples total, minus what
        ``process`` already emitted).  The stream is finished afterwards;
        ``reset()`` before reuse."""
        if self._finished:
            return np.zeros(0, np.float32)
        self._finished = True
        hop = self.hop
        n_blocks = -(-self._n_in // hop) if self._n_in else 0
        total_target = n_blocks * hop  # offline trimmed output length
        # pad with zeros until every needed frame has been processed; zero
        # frames contribute nothing (mask * 0 spectrum == 0)
        outs = []
        while self._emitted < total_target:
            deficit = total_target - self._emitted
            self._buf = np.concatenate(
                [self._buf, np.zeros(self.block * hop, np.float32)])
            out = self._run_blocks()
            if out.size:
                outs.append(out[:deficit])
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# server-internal paced-load harness
# ---------------------------------------------------------------------------

def paced_load(multi, seconds: float = 20.0, fs: int = 16000,
               gather_frac: float = 0.25, seed: int = 7654):
    """Paced real-time load generated INSIDE the calling process: no
    sockets, no per-client threads or processes.

    Client processes that share the server's CPU cores can miss their
    own capture schedule, and a measurement would then blame the server
    for the clients' lateness.  Here arrival times are COMPUTED from each
    stream's capture
    schedule (stream i's block k is fully captured at
    ``t0 + phase_i + (k+1) * block_dur``) instead of delivered through
    the OS, so the only wall-clock consumers are this loop and the
    device step -- the quantity under test.  The batching policy
    replicates the event-loop server's coordinator
    (scripts/serve.py SelectorStreamServer): step as soon as every live
    stream has a block, else wait up to ``gather_frac`` blocks for
    near-simultaneous arrivals, one block per stream per step, backlogged
    streams catch up one block per step.

    Returns (lat, taken): ``lat[i]`` is stream i's per-block reply
    latency list in seconds (completion wall time minus the block's
    capture time), ``taken[i]`` the number of blocks served.
    """
    import time

    S = multi.n_streams
    blk = multi.block_samples
    block_dur = blk / fs
    n_blocks = max(2, int(round(seconds / block_dur)))
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, block_dur, S)
    chunks = 0.1 * rng.standard_normal((S, blk)).astype(np.float32)

    # compile + latency fill OUTSIDE the paced clock
    multi.step(chunks, np.ones(S, bool))
    multi.step(chunks)

    taken = np.zeros(S, np.int64)
    lat = [[] for _ in range(S)]
    t0 = time.monotonic() + 0.01

    def arrival(i, k):
        return t0 + phase[i] + (k + 1) * block_dur

    deadline = None
    while np.any(taken < n_blocks):
        now = time.monotonic()
        avail = np.floor((now - t0 - phase) / block_dur).astype(np.int64)
        avail = np.minimum(avail, n_blocks)
        live = taken < n_blocks
        ready = (avail > taken) & live
        if not ready.any():
            deadline = None
            nxt = min(arrival(i, taken[i]) for i in np.nonzero(live)[0])
            time.sleep(max(0.0, min(nxt - time.monotonic(), 0.25)))
            continue
        if ready.sum() < live.sum():
            # the server's gather window: near-simultaneous arrivals ride
            # ONE full-batch step instead of splitting across two
            if deadline is None:
                deadline = now + gather_frac * block_dur
            if now < deadline:
                time.sleep(min(2e-3, deadline - now))
                continue
        deadline = None
        active = ready.copy()
        multi.step(chunks, active)
        done_t = time.monotonic()
        for i in np.nonzero(active)[0]:
            lat[i].append(done_t - arrival(i, int(taken[i])))
            taken[i] += 1
    return lat, taken


def paced_stats(lat, block_dur: float):
    """Summary of :func:`paced_load` latencies: percentiles (ms), mean
    drift between the 2nd and last quarter of each stream's run (ms --
    positive = falling behind), and whether the load keeps up (latency
    stationary to within a quarter block)."""
    all_lat = np.concatenate([np.asarray(v[1:]) for v in lat if len(v) > 1])
    p50, p95, p99 = np.percentile(all_lat, [50, 95, 99]) * 1e3
    drifts = []
    for v in lat:
        a = np.asarray(v[1:])
        q = len(a) // 4
        if q >= 1:
            drifts.append(a[-q:].mean() - a[q : 2 * q].mean())
    drift = float(np.mean(drifts)) * 1e3 if drifts else 0.0
    return {
        "p50_ms": round(float(p50), 1),
        "p95_ms": round(float(p95), 1),
        "p99_ms": round(float(p99), 1),
        "drift_ms_per_quarter": round(drift, 1),
        "keeps_up": bool(drift < 0.25 * block_dur * 1e3),
    }

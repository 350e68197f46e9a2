"""Streaming enhancement: chunked online output == offline pipeline."""

import numpy as np
import jax.numpy as jnp
import pytest

from drnmf_tpu.dsp import stft, istft
from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
from drnmf_tpu.models.drnmf import drnmf_forward
from drnmf_tpu.streaming import StreamingEnhancer


def offline_enhance(params, config, x, n_fft, hop):
    spec = stft(jnp.asarray(x), n_fft, hop)  # (T, F)
    mag = jnp.abs(spec)
    irm = drnmf_forward(params, config, mag[None])[0]
    out = istft(spec * irm.astype(spec.dtype), n_fft, hop, nsampl=len(x))
    return np.asarray(out)


@pytest.fixture
def small_model(rng):
    f_bins, r = 33, 4  # n_fft=64
    w = rng.uniform(0.05, 1.0, (f_bins, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f_bins, r=r, output_dim=f_bins,
                         K_layers=2, alph=10.0, lam1=0.5)
    return init_drnmf_params(config, w), config


@pytest.mark.parametrize("block_frames", [4, 16])
def test_streaming_matches_offline(rng, small_model, block_frames):
    params, config = small_model
    n_fft, hop = 64, 16
    x = (rng.standard_normal(3000) * 0.2).astype(np.float32)

    enh = StreamingEnhancer(params, config, n_fft, hop,
                            block_frames=block_frames)
    # irregular chunk sizes, including tiny and huge
    chunks, i = [], 0
    for size in [7, 250, 1, 999, 123, 800, 2000]:
        chunks.append(x[i : i + size])
        i += size
    chunks.append(x[i:])

    outs = [enh.process(c) for c in chunks]
    outs.append(enh.flush())
    streamed = np.concatenate(outs)

    offline = offline_enhance(params, config, x, n_fft, hop)
    assert len(streamed) >= len(offline)
    np.testing.assert_allclose(streamed[: len(offline)], offline,
                               rtol=1e-4, atol=1e-5)


def test_streaming_reset_and_reuse(rng, small_model):
    params, config = small_model
    n_fft, hop = 64, 16
    x = (rng.standard_normal(1200) * 0.2).astype(np.float32)
    enh = StreamingEnhancer(params, config, n_fft, hop, block_frames=8)
    a = np.concatenate([enh.process(x), enh.flush()])
    enh.reset()
    b = np.concatenate([enh.process(x), enh.flush()])
    np.testing.assert_array_equal(a, b)


def test_streaming_latency_bound(small_model):
    params, config = small_model
    enh = StreamingEnhancer(params, config, 64, 16, block_frames=4)
    assert enh.latency_samples == 3 * 16 + 64
    # tiny dribble: nothing can be emitted before the latency bound
    out = enh.process(np.zeros(16, np.float32))
    assert out.size == 0


def test_streaming_flush_is_final(rng, small_model):
    params, config = small_model
    enh = StreamingEnhancer(params, config, 64, 16, block_frames=8)
    x = (rng.standard_normal(500) * 0.2).astype(np.float32)
    enh.process(x)
    first = enh.flush()
    assert first.size > 0
    # double flush emits nothing; process after flush is an error
    assert enh.flush().size == 0
    with pytest.raises(RuntimeError, match="reset"):
        enh.process(x)


def test_streaming_short_signal(rng, small_model):
    """A signal shorter than the pipeline latency still flushes to the
    offline output."""
    params, config = small_model
    n_fft, hop = 64, 16
    x = (rng.standard_normal(50) * 0.2).astype(np.float32)
    enh = StreamingEnhancer(params, config, n_fft, hop, block_frames=8)
    out = np.concatenate([enh.process(x), enh.flush()])
    offline = offline_enhance(params, config, x, n_fft, hop)
    assert len(out) >= len(offline)
    np.testing.assert_allclose(out[: len(offline)], offline,
                               rtol=1e-4, atol=1e-5)


def test_serve_protocol_matches_offline(rng, small_model):
    """scripts/serve.py: the TCP length-prefixed protocol streams chunks
    through a per-connection StreamingEnhancer; the concatenated replies
    equal the offline pipeline.  Exercised over a socketpair (no port)."""
    import os
    import socket
    import struct
    import sys
    import threading

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import serve

    params, config = small_model
    n_fft, hop = 64, 16
    x = (rng.standard_normal(2500) * 0.2).astype(np.float32)

    srv_sock, cli_sock = socket.socketpair()
    err = []

    def run():
        try:
            serve.serve_connection(
                srv_sock,
                lambda: StreamingEnhancer(params, config, n_fft, hop,
                                          block_frames=8))
        except Exception as e:  # surfaced below
            err.append(e)
        finally:
            srv_sock.close()

    th = threading.Thread(target=run)
    th.start()

    def send(chunk):
        chunk = np.asarray(chunk, np.float32)
        cli_sock.sendall(struct.pack("<i", chunk.size) + chunk.tobytes())

    def recv_reply():
        (m,) = struct.unpack("<i", serve._recv_exact(cli_sock, 4))
        return np.frombuffer(serve._recv_exact(cli_sock, 4 * m), dtype="<f4")

    outs = []
    for i in range(0, len(x), 600):
        send(x[i : i + 600])
        outs.append(recv_reply())
    send(np.zeros(0, np.float32))  # flush request
    outs.append(recv_reply())
    cli_sock.close()
    th.join(timeout=60)
    assert not err, err
    streamed = np.concatenate(outs)

    offline = offline_enhance(params, config, x, n_fft, hop)
    assert len(streamed) >= len(offline)
    np.testing.assert_allclose(streamed[: len(offline)], offline,
                               rtol=1e-4, atol=1e-5)


def test_serve_multi_concurrent_clients_match_offline(rng, small_model):
    """scripts/serve.py --streams: concurrent clients through one batched
    MultiStreamEnhancer each receive exactly the offline pipeline's output
    despite different signal lengths, chunk sizes, and pacing."""
    import os
    import socket
    import struct
    import sys
    import threading

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    import serve
    from drnmf_tpu.streaming import MultiStreamEnhancer

    params, config = small_model
    n_fft, hop, block = 64, 16, 4
    n_clients = 3
    sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (2500, 1200, 3100)]
    chunks = [600, 257, 911]  # deliberately not block multiples

    multi = MultiStreamEnhancer(params, config, n_clients, n_fft=n_fft,
                                hop=hop, block_frames=block)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(n_clients)
    port = srv.getsockname()[1]

    srv_err = []

    def run_server():
        try:
            serve.serve_multi(srv, multi, max_connections=n_clients,
                              timeout=60.0, verbose=False)
        except Exception as e:
            srv_err.append(e)

    th = threading.Thread(target=run_server)
    th.start()

    results, errs = [None] * n_clients, []

    def client(c):
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=60)
            outs = []

            def recv_reply():
                (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
                return np.frombuffer(serve._recv_exact(sock, 4 * m),
                                     dtype="<f4")

            x = sigs[c]
            for i in range(0, len(x), chunks[c]):
                part = np.asarray(x[i : i + chunks[c]], np.float32)
                sock.sendall(struct.pack("<i", part.size) + part.tobytes())
                outs.append(recv_reply())
            sock.sendall(struct.pack("<i", 0))
            outs.append(recv_reply())
            sock.close()
            results[c] = np.concatenate(outs)
        except Exception as e:
            errs.append((c, e))

    cths = [threading.Thread(target=client, args=(c,))
            for c in range(n_clients)]
    for t in cths:
        t.start()
    for t in cths:
        t.join(timeout=120)
    th.join(timeout=120)
    assert not errs, errs
    assert not srv_err, srv_err

    for c in range(n_clients):
        offline = offline_enhance(params, config, sigs[c], n_fft, hop)
        got = results[c]
        assert got is not None and len(got) >= len(offline), c
        np.testing.assert_allclose(got[: len(offline)], offline,
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"client {c}")


def test_multistream_equals_per_stream(rng):
    """MultiStreamEnhancer: S lockstep streams through ONE batched block
    step equal S independent StreamingEnhancers sample for sample
    (including the latency fill and a mid-run stream reset)."""
    import jax.numpy as jnp
    from drnmf_tpu.streaming import StreamingEnhancer, MultiStreamEnhancer

    f, r, K = 33, 4, 2
    n_fft, hop, block = 64, 16, 4
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.3,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)

    S = 3
    n_steps = 6
    blk = block * hop
    sigs = [rng.uniform(-0.5, 0.5, (n_steps * blk,)).astype(np.float32)
            for _ in range(S)]

    multi = MultiStreamEnhancer(params, config, S, n_fft=n_fft, hop=hop,
                                block_frames=block)
    got = [[] for _ in range(S)]
    for t in range(n_steps):
        outs = multi.step(np.stack([sig[t * blk:(t + 1) * blk]
                                    for sig in sigs]))
        for s in range(S):
            got[s].append(outs[s])
    got = [np.concatenate(g) for g in got]

    for s in range(S):
        single = StreamingEnhancer(params, config, n_fft=n_fft, hop=hop,
                                   block_frames=block)
        want = []
        for t in range(n_steps):
            want.append(single.process(sigs[s][t * blk:(t + 1) * blk]))
        want = np.concatenate(want)
        np.testing.assert_allclose(got[s], want, atol=2e-6,
                                   err_msg=f"stream {s}")

    # recycling a slot restarts that stream exactly
    multi.reset_stream(1)
    outs = multi.step(np.stack([sig[:blk] for sig in sigs]))
    fresh = StreamingEnhancer(params, config, n_fft=n_fft, hop=hop,
                              block_frames=block)
    want0 = fresh.process(sigs[1][:blk])
    np.testing.assert_allclose(outs[1], want0, atol=2e-6)


def test_multistream_active_mask_equals_per_stream(rng):
    """Streams advanced under an interleaved ``active`` schedule (each
    stream stepped a different number of times, in different orders) match
    dedicated StreamingEnhancers sample for sample, including the final
    flush_stream drain -- the mask must neither corrupt idle streams'
    state nor perturb active rows."""
    from drnmf_tpu.streaming import StreamingEnhancer, MultiStreamEnhancer

    f, r, K = 33, 4, 2
    n_fft, hop, block = 64, 16, 4
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.3,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)

    S, blk = 3, block * hop
    # per-stream signal lengths: different block counts + partial tails
    n_blocks = [5, 3, 4]
    tails = [7, 0, 2 * hop + 3]
    sigs = [rng.uniform(-0.5, 0.5, (nb * blk + tl,)).astype(np.float32)
            for nb, tl in zip(n_blocks, tails)]

    multi = MultiStreamEnhancer(params, config, S, n_fft=n_fft, hop=hop,
                                block_frames=block)
    got = [[] for _ in range(S)]
    fed = [0] * S
    # interleaved schedule: each round activates a different subset
    schedule = [(0,), (1, 2), (0, 2), (0, 1), (2,), (0, 1), (2,), (0,)]
    for round_streams in schedule:
        act = np.zeros(S, bool)
        samples = np.zeros((S, blk), np.float32)
        for s in round_streams:
            if fed[s] < n_blocks[s]:
                act[s] = True
                samples[s] = sigs[s][fed[s] * blk:(fed[s] + 1) * blk]
                fed[s] += 1
        if not act.any():
            continue
        outs = multi.step(samples, active=act)
        for s in range(S):
            if act[s]:
                got[s].append(outs[s])
            else:
                assert outs[s] is None
    assert fed == n_blocks  # schedule covered every block
    for s in range(S):
        got[s].append(multi.flush_stream(s, tail=sigs[s][n_blocks[s] * blk:]))

    for s in range(S):
        single = StreamingEnhancer(params, config, n_fft=n_fft, hop=hop,
                                   block_frames=block)
        want = np.concatenate([single.process(sigs[s]), single.flush()])
        gs = np.concatenate(got[s])
        assert len(gs) == len(want)
        np.testing.assert_allclose(gs, want, atol=2e-6, err_msg=f"stream {s}")


def test_multistream_flush_stream_equals_single_flush(rng):
    """flush_stream drains one slot to the exact offline output length
    (ceil(n/hop)*hop total) like StreamingEnhancer.flush -- including a
    trailing partial block passed as ``tail`` -- and recycles the slot."""
    from drnmf_tpu.streaming import StreamingEnhancer, MultiStreamEnhancer

    f, r, K = 33, 4, 2
    n_fft, hop, block = 64, 16, 4
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                         alph=10.0, lam1=0.3,
                         params_untied=("log_D", "log_alph"))
    params = init_drnmf_params(config, w)

    S = 2
    blk = block * hop
    n_steps = 4
    tail_len = 3 * hop + 5  # deliberately not a block multiple
    sigs = [rng.uniform(-0.5, 0.5, (n_steps * blk + tail_len,)
                        ).astype(np.float32) for _ in range(S)]

    multi = MultiStreamEnhancer(params, config, S, n_fft=n_fft, hop=hop,
                                block_frames=block)
    got = [[] for _ in range(S)]
    for t in range(n_steps):
        outs = multi.step(np.stack([sig[t * blk:(t + 1) * blk]
                                    for sig in sigs]))
        for s in range(S):
            got[s].append(outs[s])
    got[0].append(multi.flush_stream(0, tail=sigs[0][n_steps * blk:]))
    got = {0: np.concatenate(got[0])}

    single = StreamingEnhancer(params, config, n_fft=n_fft, hop=hop,
                               block_frames=block)
    want = [single.process(sigs[0])]
    want.append(single.flush())
    want = np.concatenate(want)
    assert len(got[0]) == len(want)  # == ceil(n/hop)*hop, offline length
    np.testing.assert_allclose(got[0], want, atol=2e-6)

    # the flushed slot is recycled: fresh-stream semantics
    outs = multi.step(np.stack([sigs[s][:blk] for s in range(S)]))
    fresh = StreamingEnhancer(params, config, n_fft=n_fft, hop=hop,
                              block_frames=block)
    np.testing.assert_allclose(outs[0], fresh.process(sigs[0][:blk]),
                               atol=2e-6)


class _StubMulti:
    """Stand-in MultiStreamEnhancer: each block's 'enhancement' is the
    input + 1000*(1+stream index), so a reply's provenance is checkable."""

    def __init__(self, n_streams, blk, step_delay=0.0, fail_after=None):
        import threading
        self.n_streams = n_streams
        self.block_samples = blk
        self.step_delay = step_delay
        self.fail_after = fail_after
        self.steps = 0
        self._lock = threading.Lock()

    def step(self, samples, active=None):
        return self.step_fetch(self.step_dispatch(samples, active))

    def step_dispatch(self, samples, active=None):
        import time
        with self._lock:
            self.steps += 1
            if self.fail_after is not None and self.steps > self.fail_after:
                raise RuntimeError("injected device failure")
        if self.step_delay:
            time.sleep(self.step_delay)
        if active is None:
            active = np.ones(self.n_streams, bool)
        return [samples[i] + 1000.0 * (1 + i) if active[i] else None
                for i in range(self.n_streams)]

    def step_fetch(self, handle):
        return handle

    def flush_stream(self, i, tail=None):
        t = np.zeros(0, np.float32) if tail is None else tail
        return np.asarray(t + 1000.0 * (1 + i), np.float32)

    def reset_stream(self, i):
        pass


def _import_serve():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import serve
    return serve


def _serve_stub(multi, n_conn, timeout=30.0):
    import socket
    import threading

    serve = _import_serve()

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(n_conn)
    th = threading.Thread(
        target=serve.serve_multi,
        args=(srv, multi),
        kwargs=dict(max_connections=n_conn, timeout=timeout, verbose=False),
        daemon=True)
    th.start()
    return srv, srv.getsockname()[1], th


def test_serve_multi_reply_carries_block_output():
    """Each full-block chunk's reply contains THAT block's enhanced
    samples even while another chatty client's notifications race the
    coordinator's device step (review r3: the reader could previously be
    woken between pop_block and the outbox append, replying one step
    early)."""
    import socket
    import struct
    import threading

    serve = _import_serve()

    blk = 64
    multi = _StubMulti(2, blk, step_delay=0.02)
    srv, port, th = _serve_stub(multi, 2)

    stop = threading.Event()

    def chatty():
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        part = np.zeros(3, np.float32)  # never completes a block
        while not stop.is_set():
            sock.sendall(struct.pack("<i", part.size) + part.tobytes())
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            serve._recv_exact(sock, 4 * m)
        sock.sendall(struct.pack("<i", 0))
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        sock.close()

    cth = threading.Thread(target=chatty, daemon=True)
    cth.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        for k in range(20):
            x = np.full(blk, float(k), np.float32)
            sock.sendall(struct.pack("<i", x.size) + x.tobytes())
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            out = np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")
            # the stub's per-block output is input + offset: the reply for
            # chunk k must contain exactly block k's samples
            assert m == blk, f"chunk {k}: reply had {m} samples"
            offset = out[0] - float(k)
            assert offset in (1000.0, 2000.0), f"chunk {k}: offset {offset}"
            np.testing.assert_array_equal(out, x + offset)
        sock.sendall(struct.pack("<i", 0))
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        sock.close()
    finally:
        stop.set()
        cth.join(timeout=10)
        th.join(timeout=10)
        srv.close()


def test_serve_multi_coordinator_failure_fails_fast():
    """A device error inside the coordinator must fail connected clients
    promptly instead of hanging them forever
    on a dead daemon thread (review r3)."""
    import socket
    import struct

    serve = _import_serve()

    blk = 32
    multi = _StubMulti(1, blk, fail_after=2)
    srv, port, th = _serve_stub(multi, 1, timeout=10.0)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.settimeout(20.0)
        x = np.zeros(blk, np.float32)
        failed = False
        for k in range(6):
            try:
                sock.sendall(struct.pack("<i", x.size) + x.tobytes())
                (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
                serve._recv_exact(sock, 4 * m)
            except (ConnectionError, socket.timeout, struct.error):
                failed = True
                break
        assert failed, "client was never disconnected after coordinator death"
    finally:
        th.join(timeout=15)
        srv.close()
        assert not th.is_alive(), "serve_multi accept loop did not exit"


# ---------------------------------------------------------------------------
# round-4 event-loop server (scripts/serve.py SelectorStreamServer)
# ---------------------------------------------------------------------------

def _serve_stub_selector(multi, n_conn, timeout=30.0):
    import socket
    import threading

    serve = _import_serve()

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(n_conn)
    err = []

    def run():
        try:
            serve.serve_multi_selector(
                srv, multi, max_connections=n_conn, timeout=timeout,
                verbose=False)
        except Exception as e:
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return srv, srv.getsockname()[1], th, err


def test_serve_selector_concurrent_clients_match_offline(rng, small_model):
    """Event-loop server (3 threads total): concurrent clients each get
    exactly the offline pipeline's output -- same contract as the
    thread-per-reader server, different host architecture."""
    import socket
    import struct
    import threading

    serve = _import_serve()
    from drnmf_tpu.streaming import MultiStreamEnhancer

    params, config = small_model
    n_fft, hop, block = 64, 16, 4
    n_clients = 3
    sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (2500, 1200, 3100)]
    chunks = [600, 257, 911]

    multi = MultiStreamEnhancer(params, config, n_clients, n_fft=n_fft,
                                hop=hop, block_frames=block)
    srv, port, th, srv_err = _serve_stub_selector(multi, n_clients,
                                                  timeout=60.0)
    results, errs = [None] * n_clients, []

    def client(c):
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=60)
            outs = []

            def recv_reply():
                (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
                return np.frombuffer(serve._recv_exact(sock, 4 * m),
                                     dtype="<f4")

            x = sigs[c]
            for i in range(0, len(x), chunks[c]):
                part = np.asarray(x[i : i + chunks[c]], np.float32)
                sock.sendall(struct.pack("<i", part.size) + part.tobytes())
                outs.append(recv_reply())
            sock.sendall(struct.pack("<i", 0))
            outs.append(recv_reply())
            sock.close()
            results[c] = np.concatenate(outs)
        except Exception as e:
            errs.append((c, e))

    cths = [threading.Thread(target=client, args=(c,))
            for c in range(n_clients)]
    for t in cths:
        t.start()
    for t in cths:
        t.join(timeout=120)
    th.join(timeout=120)
    assert not errs, errs
    assert not srv_err, srv_err
    for c in range(n_clients):
        offline = offline_enhance(params, config, sigs[c], n_fft, hop)
        got = results[c]
        assert got is not None and len(got) >= len(offline), c
        np.testing.assert_allclose(got[: len(offline)], offline,
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"client {c}")


def test_serve_selector_reply_carries_block_output():
    """Event-loop server: each full-block chunk's reply contains THAT
    block's samples while a chatty sub-block client races the
    coordinator (the wakeup-race guarantee carries over)."""
    import socket
    import struct
    import threading

    serve = _import_serve()

    blk = 64
    multi = _StubMulti(2, blk, step_delay=0.02)
    srv, port, th, srv_err = _serve_stub_selector(multi, 2)

    stop = threading.Event()

    def chatty():
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        part = np.zeros(3, np.float32)
        while not stop.is_set():
            sock.sendall(struct.pack("<i", part.size) + part.tobytes())
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            serve._recv_exact(sock, 4 * m)
        sock.sendall(struct.pack("<i", 0))
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        sock.close()

    cth = threading.Thread(target=chatty, daemon=True)
    cth.start()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        for k in range(20):
            x = np.full(blk, float(k), np.float32)
            sock.sendall(struct.pack("<i", x.size) + x.tobytes())
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            out = np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")
            assert m == blk, f"chunk {k}: reply had {m} samples"
            offset = out[0] - float(k)
            assert offset in (1000.0, 2000.0), f"chunk {k}: offset {offset}"
            np.testing.assert_array_equal(out, x + offset)
        sock.sendall(struct.pack("<i", 0))
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        sock.close()
    finally:
        stop.set()
        cth.join(timeout=10)
        th.join(timeout=10)
        srv.close()
    assert not srv_err, srv_err


def test_serve_selector_pipelined_sender():
    """A client that sends several chunks before reading ANY reply gets
    the same per-chunk replies as a request-reply client: the selector
    commits inbox chunks strictly one owed reply at a time, mirroring
    the sequential reader's recv -> wait -> reply order."""
    import socket
    import struct

    serve = _import_serve()

    blk = 32
    multi = _StubMulti(1, blk)
    srv, port, th, srv_err = _serve_stub_selector(multi, 1)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        n_chunks = 8
        for k in range(n_chunks):  # pipelined: no reads in between
            x = np.full(blk, float(k), np.float32)
            sock.sendall(struct.pack("<i", x.size) + x.tobytes())
        for k in range(n_chunks):
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            out = np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")
            assert m == blk, f"chunk {k}: reply had {m} samples"
            np.testing.assert_array_equal(out, np.full(blk, float(k)) + 1000.0)
        sock.sendall(struct.pack("<i", 0))
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        sock.close()
    finally:
        th.join(timeout=10)
        srv.close()
    assert not srv_err, srv_err


def test_serve_selector_coordinator_failure_fails_fast():
    """A device error inside the event-loop coordinator fails connected
    clients promptly (selector drops every live socket) and the accept
    loop exits."""
    import socket
    import struct

    serve = _import_serve()

    blk = 32
    multi = _StubMulti(1, blk, fail_after=2)
    srv, port, th, srv_err = _serve_stub_selector(multi, 1, timeout=10.0)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.settimeout(20.0)
        x = np.zeros(blk, np.float32)
        failed = False
        for k in range(6):
            try:
                sock.sendall(struct.pack("<i", x.size) + x.tobytes())
                (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
                serve._recv_exact(sock, 4 * m)
            except (ConnectionError, socket.timeout, struct.error):
                failed = True
                break
        assert failed, "client was never disconnected after coordinator death"
    finally:
        th.join(timeout=15)
        srv.close()
        assert not th.is_alive(), "selector accept loop did not exit"
    assert srv_err and "coordinator failed" in str(srv_err[0])


def test_serve_selector_slot_reuse():
    """More connections than streams: slots are recycled across
    sequential connections (flush path) and after an abrupt disconnect
    (recycle path)."""
    import socket
    import struct

    serve = _import_serve()

    blk = 16
    multi = _StubMulti(1, blk)
    srv, port, th, srv_err = _serve_stub_selector(multi, 3)
    try:
        # connection 1: clean flush
        for _ in range(2):
            sock = socket.create_connection(("127.0.0.1", port), timeout=30)
            x = np.ones(blk, np.float32)
            sock.sendall(struct.pack("<i", x.size) + x.tobytes())
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            out = np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")
            np.testing.assert_array_equal(out, x + 1000.0)
            sock.sendall(struct.pack("<i", 0))
            (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
            serve._recv_exact(sock, 4 * m)
            sock.close()
        # connection 3: abrupt disconnect mid-stream, slot must recycle
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.sendall(struct.pack("<i", 8) + np.zeros(8, np.float32).tobytes())
        sock.close()
    finally:
        th.join(timeout=15)
        srv.close()
    assert not srv_err, srv_err


def test_serve_selector_halfclose_after_flush():
    """A client that sends its flush request and immediately half-closes
    the write side (shutdown SHUT_WR) still receives the final samples --
    the reviewer-found regression vs the thread server, where the EOF
    readable event dropped the connection before the flush reply."""
    import socket
    import struct

    serve = _import_serve()

    blk = 32
    multi = _StubMulti(1, blk)
    srv, port, th, srv_err = _serve_stub_selector(multi, 1)
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        x = np.ones(blk, np.float32)
        sock.sendall(struct.pack("<i", x.size) + x.tobytes())
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        tail = np.full(7, 2.0, np.float32)
        sock.sendall(struct.pack("<i", tail.size) + tail.tobytes())
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        sock.sendall(struct.pack("<i", 0))
        sock.shutdown(socket.SHUT_WR)  # half-close BEFORE reading the reply
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        out = np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")
        np.testing.assert_array_equal(out, tail + 1000.0)  # stub flush
        sock.close()
    finally:
        th.join(timeout=15)
        srv.close()
    assert not srv_err, srv_err


def test_serve_selector_halfclose_backpressured_flush_reply():
    """A half-close that lands while the (large) flush reply is still
    back-pressured in the server's write buffer must not orphan it: the
    EOF path keeps WRITE interest instead of unregistering the socket,
    so a slow reader still drains the full reply (review finding: the
    unregister left wbuf bytes with nothing to re-arm the write)."""
    import socket
    import struct
    import time as _time

    serve = _import_serve()

    blk = 65536
    multi = _StubMulti(1, blk)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    # tiny send buffer (inherited by accepted sockets) so the ~240 KB
    # flush reply is guaranteed to back-pressure
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    err = []
    import threading

    def run():
        try:
            serve.serve_multi_selector(srv, multi, max_connections=1,
                                       timeout=30.0, verbose=False)
        except Exception as e:
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    port = srv.getsockname()[1]
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        tail = np.arange(60000, dtype=np.float32)
        sock.sendall(struct.pack("<i", tail.size) + tail.tobytes())
        sock.sendall(struct.pack("<i", 0))  # flush
        _time.sleep(0.5)  # let the reply queue and partially send
        sock.shutdown(socket.SHUT_WR)
        _time.sleep(0.5)  # EOF processed while wbuf is back-pressured
        sock.settimeout(30)
        # tail chunk reply (no full block yet -> empty), then the flush
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        serve._recv_exact(sock, 4 * m)
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        out = np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")
        np.testing.assert_array_equal(out, tail + 1000.0)
        sock.close()
    finally:
        th.join(timeout=15)
        srv.close()
    assert not err, err


def test_paced_load_internal_stub():
    """paced_load (server-internal paced SLO harness: computed arrival
    schedules, no client threads/processes) against a stub enhancer:
    every stream's every block is served exactly once, one block per
    stream per step, and reply latencies are positive and bounded.
    Timing bounds are deliberately loose -- this host has 1 vCPU and
    tests share it -- the on-chip numbers come from bench --paced-slo."""
    import time

    from drnmf_tpu.streaming import paced_load, paced_stats

    calls = []

    class Stub:
        n_streams = 4
        block_samples = 1024  # 64 ms at 16 kHz

        def step(self, samples, active=None):
            if active is None:
                active = np.ones(self.n_streams, bool)
            calls.append(np.asarray(active).copy())
            time.sleep(0.002)
            return [samples[i] if active[i] else None
                    for i in range(self.n_streams)]

    lat, taken = paced_load(Stub(), seconds=1.5, fs=16000)
    n_blocks = int(round(1.5 / (1024 / 16000.0)))
    assert list(taken) == [n_blocks] * 4
    assert all(len(v) == n_blocks for v in lat)
    assert all(x > 0 for v in lat for x in v)  # replies after capture
    st = paced_stats(lat, 1024 / 16000.0)
    assert st["p50_ms"] < 128.0  # ~gather(16) + step(2) in the quiet case
    assert st["p95_ms"] >= st["p50_ms"] and st["p99_ms"] >= st["p95_ms"]
    assert st["keeps_up"]  # a 2 ms stub step at 64 ms blocks never drifts
    # paced (not full-speed): far fewer steps than S * n_blocks
    assert 2 < len(calls) - 2 <= 4 * n_blocks

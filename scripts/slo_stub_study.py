"""Host-architecture SLO check WITHOUT a device: 64 paced real-time
streams at the 128 ms block against a stub enhancer whose step sleeps a
fixed stand-in device time (80 ms by default), through the real TCP server
+ multiprocess clients.

Separates the server's host architecture from device variance: the
event-loop server should turn the crank every cycle (stationary latency,
p95 ~ gather window + step + skew), while the thread server's notify_all
thundering herd inflates p95 under the same load.
Run: python scripts/slo_stub_study.py [--threads]"""
import os, socket, sys, threading, time
import numpy as np
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

def main(use_threads=False, S=64, step_ms=80.0, seconds=20.0):
    import serve
    import bench

    class Stub:
        def __init__(self, n, blk, delay):
            self.n_streams, self.block_samples, self.delay = n, blk, delay
        def step(self, samples, active=None):
            time.sleep(self.delay)  # the measured 64-stream device step
            if active is None: active = np.ones(self.n_streams, bool)
            return [samples[i] if active[i] else None
                    for i in range(self.n_streams)]
        def flush_stream(self, i, tail=None):
            return (np.zeros(0, np.float32) if tail is None
                    else np.asarray(tail, np.float32))
        def reset_stream(self, i): pass

    fs, hop, block = 16000, 128, 16
    blk = block * hop  # 2048 samples = 128 ms
    multi = Stub(S, blk, step_ms / 1e3)
    srv = socket.socket(); srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0)); srv.listen(S)
    port = srv.getsockname()[1]
    run = serve.serve_multi if use_threads else serve.serve_multi_selector
    th = threading.Thread(target=run, args=(srv, multi),
                          kwargs=dict(max_connections=S, timeout=300.0,
                                      verbose=False), daemon=True)
    th.start()

    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    n_samp = int(seconds * fs)
    procs, c0 = [], 0
    while c0 < S:
        n_c = min(8, S - c0)
        procs.append(ctx.Process(target=bench._tcp_client_proc,
                     args=(port, c0, n_c, 7654, n_samp, blk, True, q)))
        c0 += n_c
    for p in procs: p.start()
    lat = [[] for _ in range(S)]
    for _ in procs:
        t0, t1, results = q.get()
        for c, got, lv in results: lat[c] = lv
    for p in procs: p.join()
    th.join(timeout=60)
    all_lat = np.concatenate([np.asarray(v[1:]) for v in lat])
    p50, p95, p99 = np.percentile(all_lat, [50, 95, 99]) * 1e3
    drifts = []
    for v in lat:
        a = np.asarray(v[1:]); qq = len(a)//4
        if qq >= 1: drifts.append(a[-qq:].mean() - a[qq:2*qq].mean())
    drift = float(np.mean(drifts))*1e3
    srv_name = "threads" if use_threads else "selector"
    print(f"{srv_name}: S={S} block=128ms step={step_ms}ms  "
          f"p50/p95/p99 = {p50:.0f}/{p95:.0f}/{p99:.0f} ms  "
          f"drift {drift:+.1f} ms/quarter  keeps_up={drift < 32}")

if __name__ == "__main__":
    main(use_threads="--threads" in sys.argv)

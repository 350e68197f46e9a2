#!/usr/bin/env python
"""Online enhancement server over a trained DR-NMF checkpoint.

Production-style streaming serving (the real-time counterpart of
``enhance_wav.py``): loads a model config YAML + checkpoint and serves a
bounded-latency :class:`drnmf_tpu.StreamingEnhancer` per connection over a
length-prefixed TCP protocol. The concatenated enhanced stream equals the
offline pipeline's output exactly (the streaming cell is the offline cell;
see ``drnmf_tpu/streaming.py``).

Protocol (all little-endian):
    client -> server:  int32 n, then n float32 mono samples; repeat.
                       n == 0 requests a flush-and-close.
    server -> client:  int32 m, then the m float32 samples that became
                       final (m may be 0 while latency fills); after the
                       flush reply the connection closes.

Usage:
    python scripts/serve.py -c params_unfolded_snmf_<hash>.yaml \\
        -m model_unfolded_snmf_<hash>.npz --port 7355 [--block-frames 16]

With the default ``--streams 0``, connections are served sequentially
(one enhancer at a time, fresh state per connection).  With
``--streams S``, up to S clients are served CONCURRENTLY through one
batched :class:`drnmf_tpu.MultiStreamEnhancer`: a coordinator thread
steps whichever streams have a full block queued in ONE device program
per iteration (the ``active`` mask keeps the other streams' carried
state untouched), so aggregate throughput scales with concurrent load
while each client keeps the exact per-chunk protocol and bit-exact
offline-equal output of the sequential mode.
"""

import argparse
import os
import queue
import selectors
import socket
import struct
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed mid-message")
        buf += chunk
    return buf


def _send_samples(conn, samples):
    samples = np.asarray(samples, np.float32)
    conn.sendall(struct.pack("<i", samples.size) + samples.tobytes())


# a single message is bounded to a few seconds of 16 kHz audio: a client
# int32 can otherwise demand an ~8 GB recv buffer and wedge the sequential
# server (ADVICE r2)
MAX_CHUNK_SAMPLES = 10 * 16000
RECV_TIMEOUT_S = 30.0


def serve_connection(conn, make_enhancer_state,
                     max_chunk=MAX_CHUNK_SAMPLES, timeout=RECV_TIMEOUT_S):
    """One client session: fresh enhancer, stream until the flush request.

    Oversize chunk lengths are rejected (connection dropped with an error)
    and a recv timeout bounds how long a stalled client can hold the
    sequential single-connection server."""
    if timeout:
        conn.settimeout(timeout)
    enh = make_enhancer_state()
    while True:
        (n,) = struct.unpack("<i", _recv_exact(conn, 4))
        if n < 0:
            raise ValueError(f"negative chunk length {n}")
        if n > max_chunk:
            raise ValueError(
                f"chunk length {n} exceeds the {max_chunk}-sample cap")
        if n == 0:
            _send_samples(conn, enh.flush())
            return
        data = np.frombuffer(_recv_exact(conn, 4 * n), dtype="<f4")
        _send_samples(conn, enh.process(data))


class _Slot:
    """Coordinator-side state for one connected stream."""

    def __init__(self):
        self.conn = None
        self.pending = []          # list of float32 arrays awaiting blocks
        self.pending_len = 0
        self.outbox = []           # enhanced arrays awaiting the next reply
        self.blocks_taken = 0      # blocks popped by the coordinator
        self.blocks_done = 0       # blocks whose output reached the outbox
        self.flushing = False
        self.flush_out = None      # set once drained; reader sends + closes
        self.dead = False

    def pop_block(self, blk):
        """Remove exactly ``blk`` samples from ``pending``."""
        out, need = [], blk
        while need:
            a = self.pending[0]
            if len(a) <= need:
                out.append(self.pending.pop(0))
                need -= len(a)
            else:
                out.append(a[:need])
                self.pending[0] = a[need:]
                need = 0
        self.pending_len -= blk
        return np.concatenate(out)


class MultiStreamServer:
    """Async multi-client coordinator over one MultiStreamEnhancer.

    Readers (one thread per connection) enqueue decoded chunks into their
    slot and block until the coordinator has consumed every full block of
    theirs; the coordinator steps ALL ready streams per iteration through
    one batched device program (``MultiStreamEnhancer.step(active=...)``),
    so concurrent clients batch into single dispatches while idle streams'
    state is untouched.  Per connection the protocol and output are
    exactly the sequential server's."""

    def __init__(self, multi, max_chunk=MAX_CHUNK_SAMPLES,
                 timeout=RECV_TIMEOUT_S, gather_s=None):
        self.multi = multi
        self.blk = multi.block_samples
        self.max_chunk = max_chunk
        self.timeout = timeout
        # batch-gathering window: once SOME stream has a full block, wait
        # up to this long for the OTHER live streams' blocks before
        # stepping, so near-simultaneous arrivals (real-time-paced clients
        # phase-lock through the shared replies) ride ONE full-batch device
        # program instead of splitting across two -- the fixed-shape step
        # costs the same wall regardless of how many streams are active,
        # so partial batches waste exactly that fraction of chip capacity.
        # Default: a quarter of the block duration at 16 kHz.
        self.gather_s = (0.25 * self.blk / 16000.0
                         if gather_s is None else gather_s)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.slots = [_Slot() for _ in range(multi.n_streams)]
        self.stop = False
        self.failed = None         # coordinator exception, fails all clients

    # -- coordinator ------------------------------------------------------
    def _actionable(self):
        ready = [i for i, s in enumerate(self.slots)
                 if s.conn is not None and not s.dead
                 and s.pending_len >= self.blk]
        drains = [i for i, s in enumerate(self.slots)
                  if s.conn is not None and not s.dead and s.flushing
                  and s.pending_len < self.blk and s.flush_out is None]
        deads = [i for i, s in enumerate(self.slots)
                 if s.conn is not None and s.dead]
        return ready, drains, deads

    def coordinator(self):
        try:
            self._coordinator_loop()
        except BaseException as e:
            # a device error here would otherwise kill this daemon
            # thread silently and leave every reader blocked forever: record
            # it and wake everyone so readers/claims fail fast instead
            with self.cond:
                self.failed = e
                self.cond.notify_all()
            raise

    def _n_live(self):
        return sum(1 for s in self.slots
                   if s.conn is not None and not s.dead and not s.flushing)

    def _coordinator_loop(self):
        S = self.multi.n_streams
        while True:
            with self.cond:
                deadline = None
                while True:
                    ready, drains, deads = self._actionable()
                    if drains or deads or self.stop:
                        break
                    if ready:
                        if len(ready) >= self._n_live():
                            break  # full batch: no reason to wait
                        now = time.monotonic()
                        if deadline is None:
                            deadline = now + self.gather_s
                        if now >= deadline:
                            break
                        self.cond.wait(min(deadline - now, 0.25))
                    else:
                        deadline = None
                        self.cond.wait(0.25)
                if self.stop and not (ready or drains or deads):
                    return
                samples = np.zeros((S, self.blk), np.float32)
                active = np.zeros(S, bool)
                for i in ready:
                    samples[i] = self.slots[i].pop_block(self.blk)
                    self.slots[i].blocks_taken += 1
                    active[i] = True
                tails = {i: (np.concatenate(self.slots[i].pending)
                             if self.slots[i].pending
                             else np.zeros(0, np.float32))
                         for i in drains}
            # device work OUTSIDE the lock: readers keep enqueueing.
            # (A dispatch/fetch-pipelined variant was measured SLOWER here:
            # the per-chunk request-reply protocol means clients in batch k
            # cannot produce batch k+1 until k's replies, so the pipeline
            # never overlaps and only defers replies by an iteration.)
            outs = self.multi.step(samples, active) if active.any() else None
            flush_outs = {i: self.multi.flush_stream(i, tail=tails[i])
                          for i in drains}
            with self.cond:
                for i in ready:
                    if outs is not None and outs[i] is not None \
                            and outs[i].size:
                        self.slots[i].outbox.append(outs[i])
                    self.slots[i].blocks_done += 1
                for i, fo in flush_outs.items():
                    self.slots[i].flush_out = fo
                for i in deads:
                    # reader already gone; recycle the abandoned state
                    self.multi.reset_stream(i)
                    self.slots[i].conn = None
                    self.slots[i].__init__()
                self.cond.notify_all()

    def _check_failed(self):
        if self.failed is not None:
            raise ConnectionError(
                f"server coordinator failed: {self.failed!r}")

    # -- per-connection reader --------------------------------------------
    def serve_connection(self, conn, i):
        slot = self.slots[i]
        if self.timeout:
            conn.settimeout(self.timeout)
        try:
            while True:
                (n,) = struct.unpack("<i", _recv_exact(conn, 4))
                if n < 0:
                    raise ValueError(f"negative chunk length {n}")
                if n > self.max_chunk:
                    raise ValueError(
                        f"chunk length {n} exceeds the "
                        f"{self.max_chunk}-sample cap")
                if n == 0:
                    with self.cond:
                        slot.flushing = True
                        self.cond.notify_all()
                        self.cond.wait_for(
                            lambda: slot.flush_out is not None
                            or self.failed is not None)
                        self._check_failed()
                        out = np.concatenate(
                            [np.concatenate(slot.outbox), slot.flush_out]
                        ) if slot.outbox else slot.flush_out
                    _send_samples(conn, out)
                    return
                data = np.frombuffer(_recv_exact(conn, 4 * n), dtype="<f4")
                with self.cond:
                    slot.pending.append(np.array(data))
                    slot.pending_len += n
                    self.cond.notify_all()
                    # reply once every full block of ours is consumed AND
                    # its output has landed in the outbox (blocks_done
                    # catches up to blocks_taken), so each chunk gets
                    # exactly one reply carrying its finalized samples
                    # like the sequential server
                    self.cond.wait_for(
                        lambda: (slot.pending_len < self.blk
                                 and slot.blocks_done == slot.blocks_taken)
                        or slot.dead or self.failed is not None)
                    self._check_failed()
                    out = (np.concatenate(slot.outbox) if slot.outbox
                           else np.zeros(0, np.float32))
                    slot.outbox = []
                _send_samples(conn, out)
        finally:
            with self.cond:
                if slot.flush_out is not None and not slot.dead:
                    # clean flush: flush_stream already reset device state
                    slot.__init__()
                else:
                    slot.dead = True  # coordinator recycles the state
                self.cond.notify_all()

    def claim_slot(self, conn):
        with self.cond:
            self.cond.wait_for(
                lambda: any(s.conn is None for s in self.slots)
                or self.failed is not None)
            self._check_failed()
            i = next(i for i, s in enumerate(self.slots) if s.conn is None)
            self.slots[i].__init__()
            self.slots[i].conn = conn
            return i

    def shutdown(self):
        with self.cond:
            self.stop = True
            self.cond.notify_all()


def serve_multi(srv, multi, max_connections=0, max_chunk=MAX_CHUNK_SAMPLES,
                timeout=RECV_TIMEOUT_S, verbose=True, gather_s=None):
    """Accept loop for the multi-client server: claims a slot per
    connection (blocking while all ``--streams`` slots are busy) and hands
    it to a reader thread; the coordinator batches ready streams."""
    server = MultiStreamServer(multi, max_chunk=max_chunk, timeout=timeout,
                               gather_s=gather_s)
    coord = threading.Thread(target=server.coordinator, daemon=True)
    coord.start()
    served, threads = 0, []
    try:
        while max_connections == 0 or served < max_connections:
            conn, addr = srv.accept()
            i = server.claim_slot(conn)

            def run(conn=conn, addr=addr, i=i):
                try:
                    server.serve_connection(conn, i)
                except (ConnectionError, ValueError, socket.timeout,
                        struct.error) as e:
                    if verbose:
                        print(f"connection {addr}: {e}", flush=True)
                finally:
                    conn.close()

            th = threading.Thread(target=run, daemon=True)
            th.start()
            # prune finished readers so a long-lived server holds O(live
            # connections) thread objects, not one per connection ever served
            threads = [t for t in threads if t.is_alive()]
            threads.append(th)
            served += 1
    finally:
        for th in threads:
            if th.is_alive():
                th.join(timeout=timeout or 60)
        server.shutdown()
        coord.join(timeout=10)


_FLUSH = object()    # inbox sentinel: the client requested flush-and-close
_RESERVED = object()  # slot claimed by the accept thread, socket not yet
                      # handed to the selector -- never a real connection


class _ESlot:
    """Event-loop server state for one connected stream."""

    def __init__(self):
        self.conn = None
        self.rbuf = bytearray()     # unparsed socket bytes
        self.want = 4               # bytes needed to finish current field
        self.in_header = True       # parsing the int32 length header?
        self.inbox = []             # parsed chunks not yet committed
        self.owed = False           # a committed chunk awaits its reply
        self.pending = []           # committed samples awaiting blocks
        self.pending_len = 0
        self.outbox = []            # enhanced arrays awaiting the reply
        self.blocks_taken = 0
        self.blocks_done = 0
        self.flushing = False
        self.flush_out = None
        self.wbuf = bytearray()     # reply bytes awaiting the socket
        self.close_after_write = False
        self.dead = False           # connection failed mid-stream
        self.need_recycle = False   # device state must be reset
        self.rx_eof = False         # peer half-closed while flush pending
        self.last_rx = 0.0

    def pop_block(self, blk):
        out, need = [], blk
        while need:
            a = self.pending[0]
            if len(a) <= need:
                out.append(self.pending.pop(0))
                need -= len(a)
            else:
                out.append(a[:need])
                self.pending[0] = a[need:]
                need = 0
        self.pending_len -= blk
        return np.concatenate(out)


class SelectorStreamServer:
    """Event-loop multi-client server over one MultiStreamEnhancer.

    The thread-per-reader coordinator (:class:`MultiStreamServer`) could
    not turn the crank every 128 ms at 64 streams: S reader threads plus
    the coordinator meant ~65 GIL-sharing threads, and every iteration's
    ``notify_all`` woke all of them: a host-architecture limit, not a
    device one.
    Here ONE selector thread owns every socket -- non-blocking chunk
    parsing and reply writes -- and ONE coordinator thread owns the
    device; cross-thread wakeups are a byte on a self-pipe (device ->
    selector) and a Condition shared by exactly two threads (selector ->
    coordinator).  Per-connection protocol, reply timing, and outputs are
    exactly the thread server's: chunk k's reply is sent once every full
    block queued by chunks 1..k has been stepped and its output landed
    (pipelined senders see chunks committed strictly one reply at a
    time, matching the sequential reader's recv -> wait -> reply order).
    """

    def __init__(self, multi, max_chunk=MAX_CHUNK_SAMPLES,
                 timeout=RECV_TIMEOUT_S, gather_s=None):
        self.multi = multi
        self.blk = multi.block_samples
        self.max_chunk = max_chunk
        self.timeout = timeout
        self.gather_s = (0.25 * self.blk / 16000.0
                         if gather_s is None else gather_s)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.slots = [_ESlot() for _ in range(multi.n_streams)]
        self.stop = False
        self.failed = None
        self.sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._newconns = queue.SimpleQueue()
        self._write_flags = set()   # slot ids with fresh wbuf bytes

    # -- shared helpers -----------------------------------------------------
    def _wake_selector(self):
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _check_failed(self):
        if self.failed is not None:
            raise ConnectionError(
                f"server coordinator failed: {self.failed!r}")

    def _advance(self, i):
        """Under lock: commit inbox chunks / evaluate the owed reply for
        slot i.  Returns True when new reply bytes were queued (the caller
        must ensure the selector flushes them)."""
        s = self.slots[i]
        queued = False
        while True:
            if s.owed:
                if s.flushing:
                    if s.flush_out is None:
                        break  # coordinator still draining
                    parts = s.outbox + [s.flush_out]
                    out = (np.concatenate(parts) if parts
                           else np.zeros(0, np.float32))
                    s.outbox = []
                    out = np.asarray(out, np.float32)
                    s.wbuf += struct.pack("<i", out.size) + out.tobytes()
                    s.owed = False
                    s.close_after_write = True
                    queued = True
                    break
                if s.pending_len < self.blk \
                        and s.blocks_done == s.blocks_taken:
                    out = (np.concatenate(s.outbox) if s.outbox
                           else np.zeros(0, np.float32))
                    s.outbox = []
                    out = np.asarray(out, np.float32)
                    s.wbuf += struct.pack("<i", out.size) + out.tobytes()
                    s.owed = False
                    queued = True
                else:
                    break
            elif s.inbox:
                item = s.inbox.pop(0)
                if item is _FLUSH:
                    s.flushing = True
                    s.owed = True
                    self.cond.notify_all()
                else:
                    s.pending.append(item)
                    s.pending_len += len(item)
                    s.owed = True
                    if s.pending_len >= self.blk:
                        self.cond.notify_all()
            else:
                break
        return queued

    # -- coordinator (device owner) -----------------------------------------
    def coordinator(self):
        try:
            self._coordinator_loop()
        except BaseException as e:
            with self.cond:
                self.failed = e
                self.cond.notify_all()
            self._wake_selector()
            raise

    def _actionable(self):
        ready = [i for i, s in enumerate(self.slots)
                 if s.conn is not None and not s.dead
                 and s.pending_len >= self.blk]
        drains = [i for i, s in enumerate(self.slots)
                  if s.conn is not None and not s.dead and s.flushing
                  and s.pending_len < self.blk and s.flush_out is None]
        recycles = [i for i, s in enumerate(self.slots) if s.need_recycle]
        return ready, drains, recycles

    def _n_live(self):
        return sum(1 for s in self.slots
                   if s.conn is not None and not s.dead and not s.flushing)

    def _coordinator_loop(self):
        S = self.multi.n_streams
        while True:
            with self.cond:
                deadline = None
                while True:
                    ready, drains, recycles = self._actionable()
                    if drains or recycles or self.stop:
                        break
                    if ready:
                        if len(ready) >= self._n_live():
                            break
                        now = time.monotonic()
                        if deadline is None:
                            deadline = now + self.gather_s
                        if now >= deadline:
                            break
                        self.cond.wait(min(deadline - now, 0.25))
                    else:
                        deadline = None
                        self.cond.wait(0.25)
                if self.stop and not (ready or drains or recycles):
                    return
                samples = np.zeros((S, self.blk), np.float32)
                active = np.zeros(S, bool)
                for i in ready:
                    samples[i] = self.slots[i].pop_block(self.blk)
                    self.slots[i].blocks_taken += 1
                    active[i] = True
                tails = {i: (np.concatenate(self.slots[i].pending)
                             if self.slots[i].pending
                             else np.zeros(0, np.float32))
                         for i in drains}
            # device work OUTSIDE the lock (selector keeps parsing)
            outs = self.multi.step(samples, active) if active.any() else None
            flush_outs = {i: self.multi.flush_stream(i, tail=tails[i])
                          for i in drains}
            for i in recycles:
                self.multi.reset_stream(i)
            poke = False
            with self.cond:
                for i in ready:
                    if outs is not None and outs[i] is not None \
                            and outs[i].size:
                        self.slots[i].outbox.append(outs[i])
                    self.slots[i].blocks_done += 1
                for i, fo in flush_outs.items():
                    self.slots[i].flush_out = fo
                for i in recycles:
                    self.slots[i].__init__()  # frees the slot
                    self.cond.notify_all()
                for i in set(ready) | set(flush_outs):
                    if self._advance(i):
                        self._write_flags.add(i)
                        poke = True
            if poke:
                self._wake_selector()

    # -- selector (socket owner) ----------------------------------------------
    def _fail_conn(self, i, reason=None):
        """Selector thread: drop connection i and hand its device state to
        the coordinator for recycling."""
        s = self.slots[i]
        if s.conn is None or s.conn is _RESERVED:
            return
        try:
            self.sel.unregister(s.conn)
        except (KeyError, ValueError):
            pass
        try:
            s.conn.close()
        except OSError:
            pass
        with self.cond:
            s.dead = True
            s.need_recycle = True
            self.cond.notify_all()

    def _finish_conn(self, i):
        """Selector thread: clean close after the flush reply drained
        (flush_stream already reset the device state)."""
        s = self.slots[i]
        try:
            self.sel.unregister(s.conn)
        except (KeyError, ValueError):
            pass
        try:
            s.conn.close()
        except OSError:
            pass
        with self.cond:
            s.__init__()  # frees the slot for the accept loop
            self.cond.notify_all()

    def _on_readable(self, i):
        s = self.slots[i]
        try:
            data = s.conn.recv(262144)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._fail_conn(i)
            return
        if not data:
            # peer half-closed.  If a flush is anywhere in flight (parsed,
            # committed, or its reply already queued), the client is
            # legitimately waiting for the final samples: stop READ
            # polling (prevents a zero-byte busy spin) and let the
            # coordinator's _write_flags path deliver the reply, which
            # closes the socket.  EOF mid-stream is a failure as before.
            with self.cond:
                flushing = (s.flushing or s.close_after_write
                            or any(it is _FLUSH for it in s.inbox))
                s.rx_eof = True
                pending_write = bool(s.wbuf)
            if flushing:
                # keep WRITE interest if reply bytes are already queued
                # and back-pressured -- unregistering here would orphan
                # them (nothing re-arms the write until the coordinator
                # queues NEW bytes, which it may never do again)
                try:
                    if pending_write:
                        self.sel.modify(s.conn, selectors.EVENT_WRITE, i)
                    else:
                        self.sel.unregister(s.conn)
                except (KeyError, ValueError):
                    pass
            else:
                self._fail_conn(i)
            return
        s.last_rx = time.monotonic()
        s.rbuf += data
        poke = False
        bad = False
        with self.cond:
            while len(s.rbuf) >= s.want:
                if s.in_header:
                    (n,) = struct.unpack("<i", s.rbuf[:4])
                    del s.rbuf[:4]
                    if n < 0 or n > self.max_chunk:
                        bad = True  # _fail_conn takes this lock: defer
                        break
                    if n == 0:
                        s.inbox.append(_FLUSH)
                        s.want = 4
                    else:
                        s.in_header = False
                        s.want = 4 * n
                else:
                    arr = np.frombuffer(bytes(s.rbuf[: s.want]),
                                        dtype="<f4")
                    del s.rbuf[: s.want]
                    s.inbox.append(arr)
                    s.in_header = True
                    s.want = 4
            if not bad and self._advance(i):
                poke = True
        if bad:
            self._fail_conn(i)
            return
        if poke:
            self._flush_writes(i)

    def _flush_writes(self, i):
        """Selector thread: push slot i's queued reply bytes; keep
        EVENT_WRITE interest while the socket back-pressures."""
        s = self.slots[i]
        with self.cond:
            buf = bytes(s.wbuf)
            s.wbuf = bytearray()
        sent = 0
        try:
            while sent < len(buf):
                m = s.conn.send(buf[sent:])
                if m == 0:
                    break
                sent += m
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._fail_conn(i)
            return
        rest = buf[sent:]
        if sent:
            s.last_rx = time.monotonic()  # write progress counts as life
        with self.cond:
            if rest:
                s.wbuf = bytearray(rest) + s.wbuf
            drained = not s.wbuf
            close = drained and s.close_after_write
        events = selectors.EVENT_READ | (
            0 if drained else selectors.EVENT_WRITE)
        if close:
            self._finish_conn(i)
            return
        try:
            self.sel.modify(s.conn, events, i)
        except (KeyError, ValueError):
            if not drained:
                # socket was unregistered (half-close path) but the reply
                # is back-pressured: re-register for writability
                try:
                    self.sel.register(s.conn, events, i)
                except (KeyError, ValueError, OSError):
                    pass

    def selector_loop(self):
        while True:
            with self.lock:
                if self.stop or self.failed is not None:
                    break
            for key, events in self.sel.select(timeout=0.25):
                if key.data == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, InterruptedError):
                        pass
                    continue
                i = key.data
                if events & selectors.EVENT_READ:
                    self._on_readable(i)
                if events & selectors.EVENT_WRITE \
                        and self.slots[i].conn is not None:
                    self._flush_writes(i)
            # register newly accepted connections (selector thread only)
            while True:
                try:
                    i, conn = self._newconns.get_nowait()
                except queue.Empty:
                    break
                conn.setblocking(False)
                self.slots[i].conn = conn
                self.slots[i].last_rx = time.monotonic()
                self.sel.register(conn, selectors.EVENT_READ, i)
            # fresh reply bytes queued by the coordinator
            with self.lock:
                flags, self._write_flags = self._write_flags, set()
            for i in flags:
                if self.slots[i].conn not in (None, _RESERVED):
                    self._flush_writes(i)
            # recv timeouts (coarse); _RESERVED slots are not sockets yet.
            # A half-closed flushing peer sends nothing by design, so it
            # is exempt UNLESS its reply bytes are back-pressured with no
            # send progress (a vanished reader would leak the slot)
            if self.timeout:
                now = time.monotonic()
                for i, s in enumerate(self.slots):
                    if (s.conn is not None and s.conn is not _RESERVED
                            and not s.dead
                            and (not s.rx_eof or s.wbuf)
                            and now - s.last_rx > self.timeout):
                        self._fail_conn(i)
        # shutdown or coordinator failure: drop every live connection
        for i, s in enumerate(self.slots):
            if s.conn is not None and s.conn is not _RESERVED:
                try:
                    self.sel.unregister(s.conn)
                except (KeyError, ValueError):
                    pass
                try:
                    s.conn.close()
                except OSError:
                    pass
        self.sel.close()

    def submit(self, conn):
        """Accept thread: claim a free slot (blocking) and hand the
        connection to the selector."""
        with self.cond:
            self.cond.wait_for(
                lambda: any(s.conn is None and not s.need_recycle
                            for s in self.slots)
                or self.failed is not None)
            self._check_failed()
            i = next(i for i, s in enumerate(self.slots)
                     if s.conn is None and not s.need_recycle)
            self.slots[i].__init__()
            self.slots[i].conn = _RESERVED  # selector sets the socket
            self.slots[i].last_rx = time.monotonic()
        self._newconns.put((i, conn))
        self._wake_selector()
        return i

    def wait_all_closed(self, timeout=60.0):
        with self.cond:
            self.cond.wait_for(
                lambda: all(s.conn is None for s in self.slots)
                or self.failed is not None,
                timeout=timeout)

    def shutdown(self):
        with self.cond:
            self.stop = True
            self.cond.notify_all()
        self._wake_selector()
        try:
            self._wake_w.close()
        except OSError:
            pass


def serve_multi_selector(srv, multi, max_connections=0,
                         max_chunk=MAX_CHUNK_SAMPLES, timeout=RECV_TIMEOUT_S,
                         verbose=True, gather_s=None):
    """Accept loop for the event-loop server: 3 threads total (accept +
    selector + coordinator) regardless of stream count, versus the thread
    server's 1 + S."""
    server = SelectorStreamServer(multi, max_chunk=max_chunk,
                                  timeout=timeout, gather_s=gather_s)
    coord = threading.Thread(target=server.coordinator, daemon=True)
    selth = threading.Thread(target=server.selector_loop, daemon=True)
    coord.start()
    selth.start()
    served = 0
    try:
        while max_connections == 0 or served < max_connections:
            conn, addr = srv.accept()
            try:
                server.submit(conn)
            except ConnectionError as e:
                if verbose:
                    print(f"connection {addr}: {e}", flush=True)
                conn.close()
                break
            served += 1
        server.wait_all_closed(timeout=timeout or 60)
    finally:
        server.shutdown()
        selth.join(timeout=10)
        coord.join(timeout=10)
        if server.failed is not None:
            raise ConnectionError(
                f"server coordinator failed: {server.failed!r}")


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--config", required=True, help="model YAML")
    parser.add_argument("-m", "--model", required=True, help="checkpoint .npz")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7355)
    parser.add_argument("--n-fft", type=int, default=512)
    parser.add_argument("--hop", type=int, default=128)
    parser.add_argument("--block-frames", type=int, default=16,
                        help="frames per device step; latency is "
                        "(block_frames-1)*hop + n_fft samples")
    parser.add_argument("--max-connections", type=int, default=0,
                        help="exit after N connections (0 = serve forever)")
    parser.add_argument("--streams", type=int, default=0,
                        help="serve up to N clients concurrently through "
                        "one batched MultiStreamEnhancer (0 = sequential)")
    parser.add_argument("--reader-threads", action="store_true",
                        help="use the thread-per-connection coordinator "
                        "instead of the default event-loop server "
                        "(3 threads total; see SelectorStreamServer)")
    args = parser.parse_args()

    from drnmf_tpu import MultiStreamEnhancer, StreamingEnhancer
    from drnmf_tpu.pipeline import drnmf_config_from_params
    from drnmf_tpu.train import load_checkpoint
    from drnmf_tpu.utils import load_yaml, enable_compile_cache

    enable_compile_cache()
    cfg = load_yaml(args.config)
    config = drnmf_config_from_params(cfg, args.n_fft // 2 + 1)
    params, _ = load_checkpoint(args.model)
    from drnmf_tpu.models.drnmf import ensure_fold_valid

    config = ensure_fold_valid(config, params)

    def fresh():
        return StreamingEnhancer(params, config, n_fft=args.n_fft,
                                 hop=args.hop,
                                 block_frames=args.block_frames)

    # compile up front so the first client doesn't pay the jit wall
    warm = fresh()
    warm.process(np.zeros(warm.latency_samples, np.float32))

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(max(1, args.streams))
    lat_ms = 1000.0 * warm.latency_samples / 16000
    mode = (f"{args.streams} concurrent batched streams" if args.streams
            else "sequential")
    print(f"serving on {args.host}:{srv.getsockname()[1]} "
          f"(block_frames={args.block_frames}, latency {lat_ms:.0f} ms "
          f"@16kHz, {mode})", flush=True)

    try:
        if args.streams:
            multi = MultiStreamEnhancer(params, config, args.streams,
                                        n_fft=args.n_fft, hop=args.hop,
                                        block_frames=args.block_frames)
            # warm the batched + flush programs too (flush_stream resets
            # the slot afterwards, so warming leaves no state behind)
            multi.step(np.zeros((args.streams, multi.block_samples),
                                np.float32))
            multi.flush_stream(0, tail=np.zeros(multi.hop, np.float32))
            for i in range(1, args.streams):
                multi.reset_stream(i)
            run = serve_multi if args.reader_threads else serve_multi_selector
            run(srv, multi, max_connections=args.max_connections)
        else:
            served = 0
            while args.max_connections == 0 or served < args.max_connections:
                conn, addr = srv.accept()
                try:
                    serve_connection(conn, fresh)
                except (ConnectionError, ValueError, socket.timeout) as e:
                    print(f"connection {addr}: {e}", flush=True)
                finally:
                    conn.close()
                served += 1
    finally:
        srv.close()


if __name__ == "__main__":
    main()

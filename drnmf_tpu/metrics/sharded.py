"""Mesh-sharded scoring engine: pow2 buckets split over a device mesh.

The reference parallelized scoring with a MATLAB ``parfor`` file pool
(score_audio.m:72-98).  The single-chip engine (engine.py) already runs
each pow2-length bucket as ONE vmapped device program.  This module
shards each bucket's file rows over a mesh
axis with ``shard_map`` -- embarrassingly parallel like parfor: no
collectives, each device scores its own files, ONE SPMD program per
bucket.  On one device it reduces to the engine; on several it scales
with the device count.

Design notes:

- Rows are dealt to shards longest-first (greedy LPT) so per-shard packed
  buffers balance; every shard is padded to the bucket's max shard shape
  (rows AND concat bytes) so the program is one static-shape SPMD
  dispatch.  Dummy rows carry length 0 and are masked out host-side.
- The per-row math is byte-identical to the single-chip engine: same
  bucketing rule, same ``_engine_bucket`` body per shard, and the ladder
  (ridge escalation + per-file host SDR fallback) IS the engine's own
  ``_score_pass`` with the device dispatches swapped for the shard_mapped
  programs -- a CPU-mesh parity test pins sharded == engine exactly.
- ``align="guard"`` rows whose on-device delay estimate is nonzero are
  re-scored through the single-chip engine's full compensation machinery
  (rare by construction: the in-repo mask pipeline is sample-aligned).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

shard_map = jax.shard_map

from .bss_eval import FLEN, _next_pow2
from .engine import _as_f32, _engine_bucket, _fused_packed_any, _score_pass
from .fused import pack_pair


@lru_cache(maxsize=64)
def _sharded_bucket_fn(mesh, axis, nfft, flen, frame_len, fs, compute_pesq):
    """One SPMD program: every device runs the full six-metric engine body
    on its own shard of the bucket (out row block (1, Bs, 7))."""

    def body(est_c, ref_c, eoff, roff, lengths, ridge):
        return _engine_bucket(
            est_c[0], ref_c[0], eoff[0], roff[0], lengths[0], ridge,
            nfft=nfft, flen=flen, frame_len=frame_len, fs=fs,
            compute_pesq=compute_pesq)[None]

    spec = P(axis)
    # check_vma=False: the body is per-shard independent (no collectives),
    # but pesq_device's internal lax.scan carries are initialized from
    # unvarying constants, which the varying-manual-axes check rejects
    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, P()),
        out_specs=spec, check_vma=False))


@lru_cache(maxsize=64)
def _sharded_fused_fn(mesh, axis, nfft, flen, frame_len):
    """Ridge-escalation retry rounds only re-run the fused (SDR/SNR/
    SegSNR) family, mirroring engine._fused_packed_any."""

    def body(est_c, ref_c, eoff, roff, lengths, ridge):
        sdr, snr, loc, glo = _fused_packed_any(
            est_c[0], ref_c[0], eoff[0], roff[0], lengths[0], ridge,
            nfft=nfft, flen=flen, frame_len=frame_len)
        return jnp.stack([sdr, snr, loc, glo], axis=1)[None]

    spec = P(axis)
    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, P()),
        out_specs=spec, check_vma=False))


def _pack_sharded(est_list, ref_list, idxs, lens, n_shards, pack_dtype,
                  convert):
    """Deal bucket rows to ``n_shards`` longest-first (greedy LPT on packed
    bytes), pack each shard, and pad all shards to a common (Bs, Ls) shape.

    Returns (est (D, Ls), ref (D, Ls), offsets (D, Bs), lengths (D, Bs),
    row_idx (D, Bs) with -1 on dummy rows)."""
    order = sorted(idxs, key=lambda i: -lens[i])
    shards = [[] for _ in range(n_shards)]
    load = np.zeros(n_shards, np.int64)
    for i in order:
        s = int(np.argmin(load))
        shards[s].append(i)
        load[s] += lens[i]
    bs = max(1, max(len(s) for s in shards))
    ls = int(load.max()) + 1  # +1 guard zero like pack_pair

    est = np.zeros((n_shards, ls), pack_dtype)
    ref = np.zeros((n_shards, ls), pack_dtype)
    offsets = np.full((n_shards, bs), ls - 1, np.int64)  # dummies -> guard
    lengths = np.zeros((n_shards, bs), np.int32)
    row_idx = np.full((n_shards, bs), -1, np.int64)
    for s, rows in enumerate(shards):
        if not rows:
            continue
        e_c, r_c, off = pack_pair(est_list, ref_list, rows, lens,
                                  pack_dtype, convert=convert)
        est[s, : len(e_c)] = e_c
        ref[s, : len(r_c)] = r_c
        offsets[s, : len(rows)] = off
        lengths[s, : len(rows)] = lens[list(rows)]
        row_idx[s, : len(rows)] = rows
    return est, ref, offsets, lengths, row_idx


def score_all_sharded(est_list, ref_list, mesh, axis=None, fs: int = 16000,
                      compute_pesq: bool = True, flen: int = FLEN,
                      tf: float = 0.01, align: str = "guard"):
    """(n_files, 6) scores + (n_files,) delay estimates, each pow2 bucket
    sharded over ``mesh``'s ``axis`` (default: its first axis).  Same
    row-level semantics (and measured bit-identical values) as
    :func:`engine.score_all_packed`; see module docstring."""
    if align not in ("guard", "off"):
        raise ValueError(f"align must be guard/off, got {align!r}")
    axis = axis or mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    n_files = len(est_list)
    S = np.zeros((n_files, 6), np.float64)
    delays = np.zeros(n_files, np.int64)
    frame_len = int(round(tf * fs))
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        lens[i] = min(len(se), len(s))
        buckets.setdefault(_next_pow2(lens[i] + flen), []).append(i)

    is_i16 = all(np.asarray(x).dtype == np.int16 for x in est_list) and all(
        np.asarray(x).dtype == np.int16 for x in ref_list)
    pack_dtype = np.int16 if is_i16 else np.float32
    convert = None if is_i16 else _as_f32

    # [nfft, row_idx (D, Bs), device args, pending (D, Bs), cache] -- the
    # same item shape engine._score_pass consumes, with one extra leading
    # shard axis everywhere (dummy rows enter with pending=False)
    work = []
    for nfft, idxs in sorted(buckets.items()):
        e, r, off, lng, ridx = _pack_sharded(
            est_list, ref_list, idxs, lens, n_dev, pack_dtype, convert)
        off_j = jnp.asarray(off)
        args = (jnp.asarray(e), jnp.asarray(r), off_j, off_j,
                jnp.asarray(lng))
        work.append([nfft, ridx, args, ridx >= 0, None])

    # the engine's ladder (base ridge -> 1e-5 -> 1e-3 -> exact host SDR
    # fallback), with the device dispatches routed through the shard_mapped
    # SPMD programs -- commit/pending semantics are the engine's own code,
    # so the sharded/engine parity holds by construction
    def bucket_fn(w, ridge):
        return _sharded_bucket_fn(mesh, axis, w[0], flen, frame_len, fs,
                                  compute_pesq)(*w[2], jnp.float32(ridge))

    def fused_fn(w, ridge):
        return _sharded_fused_fn(mesh, axis, w[0], flen, frame_len)(
            *w[2], jnp.float32(ridge))

    _score_pass(work, S, delays, flen, frame_len, fs, compute_pesq,
                slice_fn=lambda i: (_as_f32(est_list[i], lens[i]),
                                    _as_f32(ref_list[i], lens[i])),
                commit_delay=True, bucket_fn=bucket_fn, fused_fn=fused_fn)

    if align == "guard":
        shifted = np.nonzero(delays != 0)[0]
        if len(shifted):
            # rare path: delegate detection refinement + compensation to
            # the single-chip engine's machinery on just those pairs
            from .engine import score_all_packed

            S2, d2 = score_all_packed(
                [est_list[int(i)] for i in shifted],
                [ref_list[int(i)] for i in shifted],
                fs, compute_pesq=compute_pesq, flen=flen, tf=tf,
                align="guard")
            S[shifted] = S2
            delays[shifted] = d2
    return S, delays

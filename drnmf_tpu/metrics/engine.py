"""Unified on-device scoring engine: all six metrics + time alignment.

One packed host->device transfer per pow2 bucket feeds ONE device
program computing all six metrics (SDR/SNR/SegSNR via the fused program
with bucket-level ridge escalation, PESQ via pesq_device, STOI via
stoi_device) plus an integer delay estimate, returning ONE (B, 7) array --
no host metric math beyond wav decode + packing, one result fetch per
bucket.  This replaces an arrangement where the three metric families ran
on a shared host thread pool and effectively serialized.  The two design
levers are raw-PCM16 transfers (half the bytes of a float32 packed
transfer) and one program + one fetch per bucket (the device compute per
bucket is small next to a dispatch and a blocking fetch).

Time alignment (the reference aligned INSIDE its PESQ stage only --
score_audio.m:225 via pesq_16kHz's P.862 §8 machinery; its other metrics
scored the raw truncated pair, score_audio.m:186-238.  Here the same
§8-style alignment protects all six metrics -- a documented extension,
see align.py), two tiers:

- ``align="guard"`` (default -- the in-repo mask pipeline is
  sample-aligned by construction): the bucket program's own delay
  estimate (argmax FFT cross-correlation, +-MAX_LAG samples) flags
  shifted pairs, which are re-scored after constant integer-delay
  compensation.
- ``align="full"`` (the general scorer, scripts/score_audio.py): the
  P.862-style host pre-pass (``align.py``: unbounded envelope coarse +
  fine delay, utterance splitting, per-utterance delays) aligns every
  pair, handling delays beyond MAX_LAG and piecewise/drifting delays.

Either way the compensation itself runs AT BUCKET SPEED, not through a
per-file host path: constant-delay pairs re-run the SAME resident device
buffers with
shift-adjusted unpack offsets (no second transfer), and piecewise pairs
are host-reconstructed (align.compensate_piecewise) and scored through
one extra packed pass.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bss_eval import FLEN, _next_pow2, bss_eval_sdr
from .fused import _fused_padded, _unpack, pack_pair
from .pesq_device import pesq_rows
from .scoring import SCORE_LABELS  # noqa: F401  (re-export, one source)
from .stoi_device import stoi_rows

MAX_LAG = 2047  # +-128 ms at 16 kHz (the guard tier; "full" is unbounded)


def _delay_rows(est_rows, ref_rows, lengths):
    """(B,) integer delay of est relative to ref (positive: est lags), from
    the circular FFT cross-correlation.  Rows are zero-padded to the FFT
    length, so lags within the per-row padding are linear correlations;
    lags beyond it are masked out."""
    nfft = est_rows.shape[-1]
    # short buckets (nfft < 2*MAX_LAG+1) can't represent the full lag range
    max_lag = min(MAX_LAG, nfft // 2 - 1)
    ef = jnp.fft.rfft(est_rows, axis=-1)
    rf = jnp.fft.rfft(ref_rows, axis=-1)
    c = jnp.fft.irfft(ef * jnp.conj(rf), n=nfft, axis=-1)  # (B, nfft)
    lags = jnp.concatenate(
        [jnp.arange(0, max_lag + 1), jnp.arange(-max_lag, 0)])
    vals = jnp.abs(jnp.concatenate(
        [c[:, : max_lag + 1], c[:, nfft - max_lag :]], axis=-1))
    # tie-break toward zero delay; mask lags that would wrap into the signal
    vals = vals * (1.0 - 1e-6 * jnp.abs(lags)[None, :] / (max_lag + 1))
    ok = jnp.abs(lags)[None, :] <= jnp.maximum(nfft - lengths[:, None] - 1, 0)
    vals = jnp.where(ok, vals, -1.0)
    return lags[jnp.argmax(vals, axis=-1)]


def _dequant(c):
    """int16 concat buffer -> float32 on DEVICE (x / 32768, the same scale
    the native float decoder uses) -- PCM16 wav bytes cross to the device
    at half the float32 size."""
    if c.dtype == jnp.int16:
        return c.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
    return c


@partial(jax.jit, static_argnames=("nfft", "flen", "frame_len"))
def _fused_packed_any(est_c, ref_c, est_off, ref_off, lengths, ridge,
                      nfft, flen, frame_len):
    """Ridge-escalation retry program: only the fused family (SDR/SNR/
    SegSNR) depends on the ridge, so retry rounds skip the PESQ/STOI/delay
    work already computed by the first :func:`_engine_bucket` pass.
    Separate est/ref offsets express a constant-delay shift directly on
    the resident packed buffers (see module docstring)."""
    se = _unpack(_dequant(est_c), est_off, lengths, nfft)
    s = _unpack(_dequant(ref_c), ref_off, lengths, nfft)
    fn = jax.vmap(lambda a, b, n: _fused_padded(
        a, b, n, ridge, flen=flen, frame_len=frame_len))
    return fn(se, s, lengths)


@partial(jax.jit,
         static_argnames=("nfft", "flen", "frame_len", "fs", "compute_pesq"))
def _engine_bucket(est_c, ref_c, est_off, ref_off, lengths, ridge,
                   nfft, flen, frame_len, fs, compute_pesq):
    """ALL metrics + delay for one bucket as ONE program returning ONE
    (B, 7) array: every result fetch is a blocking round trip, and a split
    fused/perceptual arrangement would cost ~6 fetches per bucket."""
    se = _unpack(_dequant(est_c), est_off, lengths, nfft)
    s = _unpack(_dequant(ref_c), ref_off, lengths, nfft)
    fn = jax.vmap(lambda a, b, n: _fused_padded(
        a, b, n, ridge, flen=flen, frame_len=frame_len))
    sdr, raw_snr, loc, glo = fn(se, s, lengths)
    delay = _delay_rows(se, s, lengths)
    pesq = (pesq_rows(s, se, lengths, fs=fs) if compute_pesq
            else jnp.full(se.shape[0], -1.0))
    sto = stoi_rows(s, se, lengths, fs=fs)
    return jnp.stack(
        [sdr, raw_snr, loc, glo, pesq, sto, delay.astype(jnp.float32)],
        axis=1)


def _as_f32(x, n):
    """Host-side row normalization: slice to ``n`` samples and apply the
    SAME int16 dequant rule the device program uses (x / 32768); float
    entries pass through as float32."""
    arr = np.asarray(x[:n])
    if arr.dtype == np.int16:
        return arr.astype(np.float32) * np.float32(1.0 / 32768.0)
    return np.asarray(arr, np.float32)


def _score_pass(work, S, delays, flen, frame_len, fs, compute_pesq,
                slice_fn, commit_delay, bucket_fn=None, fused_fn=None):
    """One full engine pass over ``work`` (a list of bucket items
    ``[nfft, idxs, (est_c, ref_c, est_off, ref_off, lengths_j), mask,
    cache]``): the merged six-metric program at the base ridge, then
    ridge-escalation retry rounds (1e-7 -> 1e-5 -> 1e-3) dispatching only
    the fused family, then the exact per-file host SDR fallback
    (``slice_fn(i)`` supplies the possibly-shifted host signals).  Commits
    finished rows into ``S`` (and ``delays`` when ``commit_delay``) and
    clears them from each item's pending mask.  All first-pass programs
    are dispatched before any result fetch (each fetch is a blocking
    round trip).

    ``bucket_fn(w, ridge)`` / ``fused_fn(w, ridge)`` override the device
    dispatches (metrics/sharded.py routes them through shard_mapped SPMD
    programs); they must return results WITHOUT fetching so dispatch stays
    async across buckets.  Result/index/mask arrays may have any leading
    shape (the engine uses (B, ...), the sharded path (D, Bs, ...)) --
    every merge/commit below indexes with boolean masks, which numpy
    flattens identically for either rank."""
    if bucket_fn is None:
        def bucket_fn(w, ridge):
            return _engine_bucket(*w[2], jnp.float32(ridge), nfft=w[0],
                                  flen=flen, frame_len=frame_len, fs=fs,
                                  compute_pesq=compute_pesq)
    if fused_fn is None:
        def fused_fn(w, ridge):
            return _fused_packed_any(*w[2], jnp.float32(ridge), nfft=w[0],
                                     flen=flen, frame_len=frame_len)

    def _commit(w, vals, rows):
        S[w[1][rows]] = vals[rows, :6]
        if commit_delay:
            delays[w[1][rows]] = np.round(vals[rows, 6]).astype(np.int64)

    first = [(w, bucket_fn(w, 1e-7)) for w in work]
    for w, res in first:
        # np.array (not asarray): the retry merge writes columns in place,
        # and asarray of a jax array is a read-only view
        w[4] = np.array(res)  # (..., 7), kept for the retry merges
        newly = w[3] & np.isfinite(w[4][..., 0])
        _commit(w, w[4], newly)
        w[3] = w[3] & ~newly

    # ridge escalation: only the fused family depends on the ridge, so
    # retries dispatch the cheaper fused program and merge with the first
    # pass's PESQ/STOI/delay columns.
    for ridge in (1e-5, 1e-3):
        pending = [(w, fused_fn(w, ridge)) for w in work if w[3].any()]
        if not pending:
            break
        for w, res in pending:
            vals = w[4]
            if isinstance(res, tuple):  # per-metric arrays -> columns
                res = np.stack([np.asarray(r) for r in res], axis=-1)
            vals[..., :4] = np.asarray(res)
            need = w[3]
            newly = need & np.isfinite(vals[..., 0])
            _commit(w, vals, newly)
            need &= ~newly
            if need.any() and ridge == 1e-3:
                _commit(w, vals, need)
                for i in w[1][need]:
                    est_i, ref_i = slice_fn(int(i))
                    S[i, 0] = bss_eval_sdr(est_i, ref_i, flen=flen)
                need &= False


def score_all_packed(est_list, ref_list, fs: int = 16000,
                     compute_pesq: bool = True, flen: int = FLEN,
                     tf: float = 0.01, verbose: bool = False,
                     align: str = "guard"):
    """(n_files, 6) [SDR, SNR, SegSNR local, SegSNR global, PESQ, STOI] and
    (n_files,) estimated integer delays, computed on device per pow2
    bucket with ONE shared packed transfer per bucket.

    ``align``: "guard" compensates constant delays the bucket program's
    +-MAX_LAG estimate detects; "full" runs the P.862-style host
    alignment (unbounded + per-utterance, ``metrics/align.py``) on every
    pair; "off" disables alignment (used internally for re-passes).
    Compensated pairs are re-scored at bucket speed -- see module
    docstring.  The returned delay for a compensated pair is the APPLIED
    constant delay (piecewise pairs report their global estimate).

    ``est_list``/``ref_list`` entries may be float32 OR raw PCM int16
    (``native_loader.read_batch_i16``): int16 signals are packed and
    shipped verbatim and dequantized on device (x / 32768) -- half the
    transfer bytes, identical values."""
    if align not in ("guard", "full", "off"):
        raise ValueError(f"align must be guard/full/off, got {align!r}")
    n_files = len(est_list)
    S = np.zeros((n_files, 6), np.float64)
    delays = np.zeros(n_files, np.int64)
    frame_len = int(round(tf * fs))
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        lens[i] = min(len(se), len(s))
        buckets.setdefault(_next_pow2(lens[i] + flen), []).append(i)

    # int16 packing only when EVERY entry is int16; mixed lists fall back
    # to float32 with int16 entries dequantized host-side (packing a float
    # entry as int16 -- or an int16 entry as un-rescaled float -- would
    # silently corrupt that file's scores).
    is_i16 = all(np.asarray(x).dtype == np.int16 for x in est_list) and all(
        np.asarray(x).dtype == np.int16 for x in ref_list)
    pack_dtype = np.int16 if is_i16 else np.float32
    as_f32 = _as_f32

    work = []  # [nfft, idx array, device args, pending mask, result cache]
    for nfft, idxs in sorted(buckets.items()):
        est_c, ref_c, offsets = pack_pair(
            est_list, ref_list, idxs, lens, pack_dtype,
            convert=None if is_i16 else as_f32)
        off_j = jnp.asarray(offsets)
        args = (jnp.asarray(est_c), jnp.asarray(ref_c), off_j, off_j,
                jnp.asarray(lens[idxs], np.int32))
        work.append(
            [nfft, np.asarray(idxs), args, np.ones(len(idxs), bool), None])

    _score_pass(work, S, delays, flen, frame_len, fs, compute_pesq,
                slice_fn=lambda i: (as_f32(est_list[i], lens[i]),
                                    as_f32(ref_list[i], lens[i])),
                commit_delay=True)
    if align == "off":
        return S, delays

    # ------------------------------------------------------------------
    # alignment: decide a compensation plan per pair
    # ------------------------------------------------------------------
    const_d = {}   # i -> constant integer delay to compensate
    piecewise = {}  # i -> (utts, per-utterance delays)
    if align == "full":
        from .align import align_pair

        for i in range(n_files):
            n = int(lens[i])
            utts, uds, g = align_pair(as_f32(est_list[i], n),
                                      as_f32(ref_list[i], n), fs)
            delays[i] = int(g.d)
            if all(d == 0 for d in uds):
                delays[i] = 0
            elif len(set(uds)) == 1:
                const_d[i] = int(uds[0])
                delays[i] = int(uds[0])
            else:
                piecewise[i] = (utts, uds)
    else:
        # guard tier: the bucket program's +-MAX_LAG estimate DETECTS the
        # shift; the unbounded host estimator then refines it (the bounded
        # full-rate cross-correlation of a periodic carrier can alias to a
        # pitch-period lag; the envelope coarse stage disambiguates).
        # Aligned pairs never reach this loop, so the zero-host-cost
        # property of the guard tier is preserved.
        from .align import estimate_delay

        for i in np.nonzero(delays != 0)[0]:
            n = int(lens[i])
            de = estimate_delay(as_f32(est_list[i], n),
                                as_f32(ref_list[i], n), fs)
            delays[i] = int(de.d)
            if de.d != 0:
                const_d[int(i)] = int(de.d)

    min_keep = max(flen, frame_len)
    for i in [k for k, d in const_d.items()
              if lens[k] - abs(d) < min_keep]:
        # A delay this large relative to the file is a spurious
        # cross-correlation peak (noise-dominated estimate, or a file
        # shorter than the lag search range), not a real misalignment:
        # compensating would score (near-)empty slices and write NaN
        # rows.  Keep the already-committed unshifted scores.
        print(f"  WARNING: estimated delay of {const_d[i]} samples for "
              f"pair {i} leaves <{min_keep} overlapping samples; treating "
              f"the estimate as spurious and keeping unshifted scores")
        delays[i] = 0
        del const_d[i]

    # ------------------------------------------------------------------
    # constant delays: re-run the SAME resident device buffers with
    # shift-adjusted unpack offsets (est row starts d samples later for
    # d>0 / ref for d<0, both trimmed to the overlap) -- no second
    # transfer, one extra program + fetch per affected bucket.
    # ------------------------------------------------------------------
    if const_d:
        for i, d in sorted(const_d.items()):
            print(f"  WARNING: estimated delay of {d} samples between "
                  f"estimate and reference for pair {i}; re-scoring after "
                  f"compensation")
        work2 = []
        for w in work:
            hit = np.isin(w[1], list(const_d))
            if not hit.any():
                continue
            est_c, ref_c, off_j, _, _ = w[2]
            off = np.asarray(off_j)
            eoff, roff = off.copy(), off.copy()
            blens = lens[w[1]].copy()
            for row in np.nonzero(hit)[0]:
                d = const_d[int(w[1][row])]
                eoff[row] += max(d, 0)
                roff[row] += max(-d, 0)
                blens[row] -= abs(d)
            args2 = (est_c, ref_c, jnp.asarray(eoff), jnp.asarray(roff),
                     jnp.asarray(blens, np.int32))
            work2.append([w[0], w[1], args2, hit, None])

        def slice_shifted(i):
            d = const_d.get(i, 0)
            n = int(lens[i])
            est_i = as_f32(est_list[i], n)
            ref_i = as_f32(ref_list[i], n)
            if d > 0:
                return est_i[d:], ref_i[: n - d]
            if d < 0:
                return est_i[: n + d], ref_i[-d:]
            return est_i, ref_i

        _score_pass(work2, S, delays, flen, frame_len, fs, compute_pesq,
                    slice_fn=slice_shifted, commit_delay=False)

    # ------------------------------------------------------------------
    # piecewise delays (align="full" only): host-reconstruct the aligned
    # estimate (seams land in inter-utterance gaps) and score those pairs
    # through one extra packed pass.
    # ------------------------------------------------------------------
    if piecewise:
        idxs, e2, r2 = [], [], []
        for i, (utts, uds) in sorted(piecewise.items()):
            print(f"  WARNING: piecewise delays {uds} (utterances "
                  f"{utts}) for pair {i}; re-scoring after per-utterance "
                  f"compensation")
            from .align import compensate_piecewise

            ea, ra = compensate_piecewise(
                as_f32(est_list[i], lens[i]), as_f32(ref_list[i], lens[i]),
                utts, uds)
            if len(ra) < min_keep:
                print(f"  WARNING: compensated overlap for pair {i} too "
                      f"short; keeping unshifted scores")
                delays[i] = 0
                continue
            idxs.append(i)
            e2.append(ea)
            r2.append(ra)
        if idxs:
            S2, _ = score_all_packed(e2, r2, fs, compute_pesq=compute_pesq,
                                     flen=flen, tf=tf, align="off")
            S[np.asarray(idxs)] = S2

    n_comp = len(const_d) + len(piecewise)
    if verbose and n_comp:
        print(f"  {n_comp} pair(s) required delay compensation")
    return S, delays

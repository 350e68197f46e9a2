"""Fused per-file device metrics: SDR + SNR + SegSNR in ONE dispatch.

Each device round trip of the scoring path costs more than its math, so
the three device-side metrics share one jit'd program over the SDR path's
pow2-padded buffers.  PESQ and STOI remain host-side here.

Semantics are identical to calling :func:`bss_eval.bss_eval_sdr`,
:func:`snr.snr` (f32 here instead of f64 -- sub-1e-3 dB), and
:func:`snr.snrseg` individually; the cross-path agreement is pinned by
tests and reported by ``bench.py --score``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bss_eval import FLEN, _next_pow2, _sdr_padded, bss_eval_sdr
from .snr import _snrseg_padded


def pack_pair(a_list, b_list, idxs, lens, dtype=np.float32, convert=None):
    """Concat-buffer packing shared by every pow2-bucketed device program
    (fused / engine / pesq_device / stoi_device): the selected rows are
    packed back-to-back with a trailing zero guard row for the clip-mode
    unpack gather.  ``convert(x, n)`` overrides the per-row conversion
    (e.g. the engine's int16 or dequant paths).  Returns host arrays
    ``(a_c, b_c, offsets)``."""
    offsets = np.zeros(len(idxs), np.int64)
    pos = 0
    for row, i in enumerate(idxs):
        offsets[row] = pos
        pos += lens[i]
    a_c = np.empty(pos + 1, dtype)
    b_c = np.empty(pos + 1, dtype)
    a_c[-1] = b_c[-1] = 0
    conv = convert or (lambda x, n: np.asarray(x[:n], dtype))
    for row, i in enumerate(idxs):
        o, n = offsets[row], lens[i]
        a_c[o : o + n] = conv(a_list[i], n)
        b_c[o : o + n] = conv(b_list[i], n)
    return a_c, b_c, offsets


@partial(jax.jit, static_argnames=("flen", "frame_len"))
def _fused_padded(se, s, n_valid, ridge, flen, frame_len):
    sdr = _sdr_padded(se, s, n_valid, flen=flen, ridge=ridge)

    t = jnp.arange(se.shape[-1])
    valid = t < n_valid
    ref2 = jnp.sum(jnp.where(valid, s * s, 0.0))
    noi2 = jnp.sum(jnp.where(valid, (s - se) ** 2, 0.0))
    raw_snr = 10.0 * jnp.log10(ref2 / jnp.maximum(noi2, 1e-30))

    loc, glo = _snrseg_padded(se, s, n_valid, frame_len)
    return sdr, raw_snr, loc, glo


def fused_device_metrics(est, ref, fs: int = 16000, flen: int = FLEN,
                         tf: float = 0.01):
    """(SDR, SNR, SegSNR local, SegSNR global) for one time-aligned pair,
    computed in a single device program.  Escalates the SDR ridge like
    :func:`bss_eval.bss_eval_sdr` when the Toeplitz solve is
    rank-deficient."""
    est = np.asarray(est, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    frame_len = int(round(tf * fs))
    nfft = _next_pow2(n + flen)
    pad = nfft - n
    se_p = jnp.asarray(np.pad(est, (0, pad)))
    s_p = jnp.asarray(np.pad(ref, (0, pad)))
    for ridge in (1e-7, 1e-5, 1e-3):
        sdr, raw_snr, loc, glo = _fused_padded(
            se_p, s_p, jnp.int32(n), jnp.float32(ridge),
            flen=flen, frame_len=frame_len,
        )
        sdr = float(sdr)
        if np.isfinite(sdr):
            break
    if not np.isfinite(sdr):
        sdr = bss_eval_sdr(est, ref, flen=flen)
    return sdr, float(raw_snr), float(loc), float(glo)


def _unpack(concat, offsets, lengths, nfft):
    """(B, nfft) zero-padded rows from a packed 1-D concat buffer."""
    idx = offsets[:, None] + jnp.arange(nfft)[None, :]
    rows = jnp.take(concat, jnp.clip(idx, 0, concat.shape[0] - 1))
    valid = jnp.arange(nfft)[None, :] < lengths[:, None]
    return jnp.where(valid, rows, 0.0)


@partial(jax.jit, static_argnames=("nfft", "flen", "frame_len"))
def _fused_packed(est_c, ref_c, offsets, lengths, ridge,
                  nfft, flen, frame_len):
    se = _unpack(est_c, offsets, lengths, nfft)
    s = _unpack(ref_c, offsets, lengths, nfft)
    fn = jax.vmap(lambda a, b, n: _fused_padded(
        a, b, n, ridge, flen=flen, frame_len=frame_len))
    return fn(se, s, lengths)


def fused_metrics_packed(est_list, ref_list, fs: int = 16000,
                         flen: int = FLEN, tf: float = 0.01):
    """(n_files, 4) [SDR, SNR, SegSNR local, SegSNR global] for many pairs.

    Packed-transfer batched variant of :func:`fused_device_metrics`: per
    power-of-two FFT bucket, the truncated signals cross the host->device
    boundary as ONE 1-D concatenation each (exact bytes -- none of the
    padded-batch transfer inflation of ``bss_eval_sdr_many``), are unpacked
    into padded rows
    ON DEVICE, and all four metrics for the whole bucket run as one vmapped
    program.  Rare non-finite SDRs (rank-deficient references) are retried
    per file with the escalating ridge."""
    n_files = len(est_list)
    out = np.zeros((n_files, 4), np.float64)
    frame_len = int(round(tf * fs))
    buckets = {}
    lens = np.zeros(n_files, np.int64)
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        lens[i] = min(len(se), len(s))
        buckets.setdefault(_next_pow2(lens[i] + flen), []).append(i)

    work = []  # (nfft, rows, device args, need mask)
    for nfft, idxs in sorted(buckets.items()):
        est_c, ref_c, offsets = pack_pair(est_list, ref_list, idxs, lens)
        args = (jnp.asarray(est_c), jnp.asarray(ref_c),
                jnp.asarray(offsets), jnp.asarray(lens[idxs], np.int32))
        work.append([nfft, np.asarray(idxs), args, np.ones(len(idxs), bool)])

    # Ridge escalation at BUCKET granularity: rank-deficient (e.g.
    # near-periodic) references yield non-finite SDR at the small ridge;
    # re-running a whole bucket's batched program is far cheaper than
    # falling back per file.  Each file keeps the value from the
    # FIRST ridge where its solve is finite -- identical semantics (and
    # measured bit-identical values) to the per-file escalation in
    # fused_device_metrics / bss_eval_sdr.  Per escalation round, every
    # bucket's program is DISPATCHED before any result is fetched, so
    # device work pipelines; on well-conditioned (real speech) references
    # the first round is the only one, so no extra device work is done.
    for ridge in (1e-7, 1e-5, 1e-3):
        pending = [
            (w, _fused_packed(*w[2], jnp.float32(ridge), nfft=w[0],
                              flen=flen, frame_len=frame_len))
            for w in work if w[3].any()
        ]
        if not pending:
            break
        for w, res in pending:
            vals = np.asarray(res).T  # (B, 4)
            need = w[3]
            newly = need & np.isfinite(vals[:, 0])
            out[w[1][newly]] = vals[newly]
            need &= ~newly
            if need.any() and ridge == 1e-3:
                # still non-finite at the largest ridge: keep the SNR/SegSNR
                # columns but recompute SDR through the exact per-file
                # fallback, like fused_device_metrics does -- a NaN here
                # would otherwise propagate into per-bucket score means
                out[w[1][need]] = vals[need]
                for i in w[1][need]:
                    n = lens[i]
                    out[i, 0] = bss_eval_sdr(
                        np.asarray(est_list[i][:n], np.float32),
                        np.asarray(ref_list[i][:n], np.float32), flen=flen)
    return out

"""On-device (JAX) P.862-structured PESQ over packed signal buckets.

Device port of ``_pesq_model.pesq_mos_aligned`` (itself replacing the
reference's MATLAB/Loizou ``pesq_16kHz``, score_audio.m:225): identical
pipeline -- level align to 1e7 in the 350-3250 Hz band, Hann 512/256 STFT,
49-band Bark pitch power densities, partial frequency + smoothed gain
compensation, Zwicker loudness, deadzone/asymmetry disturbances, frame
emphasis, L6/L2 time aggregation, linear MOS map -- expressed as masked
fixed-shape array math so a whole pow2 bucket of files runs as ONE vmapped
device program (SURVEY §2: on-device equivalents, not Python stand-ins).

The host path computes in float64; this one in float32 on the device.
Measured agreement on synthetic speech+noise pairs is ~1e-3 MOS (pinned by
tests), far inside the model's own 0.10-MOS anchor calibration error.

Framing uses the hop-block trick (FRAME == 2*HOP at both the 512/256
analysis and 1024/512 level-align resolutions), so rows need only be
zero-padded to a multiple of 512 -- the pow2 FFT buckets of the SDR path
satisfy this for free and the packed transfer is shared.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bss_eval import _next_pow2
from .fused import pack_pair
from ._pesq_model import (
    _ABS_THRESH,
    _ASYM_SCALE,
    _GAMMA,
    _POWER_SCALE,
    _SL,
    _SP,
    _SYM_SCALE,
    _WIDTH,
    _band_matrix,
    _wb_input_weight,
)

_FLEN = 512
_HOP = 256
_ALIGN_FLEN = 1024
_ALIGN_HOP = 512


def _hop_frames(rows, flen):
    """(B, L) rows -> (B, L/hop - 1, flen) frames at hop = flen/2 via the
    hop-block reshape trick (no gather, no data duplication in HBM)."""
    hop = flen // 2
    blocks = rows.reshape(rows.shape[0], -1, hop)
    return jnp.concatenate([blocks[:, :-1], blocks[:, 1:]], axis=-1)


def _masked_hann_power(rows, lengths, fs, flen, lo, hi):
    """Per-row mean band power of ``rows`` over complete flen/2-hop frames
    (the _level_align measurement, at flen=1024)."""
    w = jnp.asarray(np.hanning(flen).astype(np.float32))
    fr = _hop_frames(rows, flen)  # (B, T2, flen)
    spec = jnp.fft.rfft(fr * w, axis=-1)
    f = np.linspace(0, fs / 2, flen // 2 + 1)
    band = jnp.asarray(((f >= lo) & (f <= hi)).astype(np.float32))
    m2 = jnp.maximum((lengths - flen) // (flen // 2) + 1, 0)  # (B,)
    t = jnp.arange(fr.shape[1])
    valid = (t[None, :] < m2[:, None]).astype(jnp.float32)  # (B, T2)
    p = jnp.abs(spec) ** 2  # (B, T2, F2)
    total = jnp.einsum("btf,bt,f->b", p, valid, band,
                   precision=jax.lax.Precision.HIGHEST)
    count = jnp.maximum(m2.astype(jnp.float32) * jnp.sum(band), 1.0)
    return total / count


def _masked_lpq(x, m, split=20, p=6.0, q=2.0):
    """Device port of ``_lpq_time``: L6 over half-overlapped ~split-frame
    intervals (INCLUDING the trailing partial ones, like the host path's
    ragged tail slices), L2 over intervals.  x: (B, T) zero-padded frame
    series; m: (B,) valid frame counts."""
    B, T = x.shape
    hopi = split // 2
    n_win = -(-T // hopi)
    starts = jnp.arange(n_win) * hopi  # (W,)
    idx = starts[:, None] + jnp.arange(split)[None, :]  # (W, split)
    vals = x[:, jnp.clip(idx, 0, T - 1)]  # (B, W, split)
    elem_valid = (idx[None, :, :] < m[:, None, None]).astype(jnp.float32)
    cnt = jnp.maximum(jnp.sum(elem_valid, axis=-1), 1.0)  # (B, W)
    mean_p = jnp.sum((vals**p) * elem_valid, axis=-1) / cnt
    win_val = mean_p ** (1.0 / p)
    win_valid = (starts[None, :] < m[:, None]).astype(jnp.float32)
    n_v = jnp.maximum(jnp.sum(win_valid, axis=-1), 1.0)
    return (jnp.sum((win_val**q) * win_valid, axis=-1) / n_v) ** (1.0 / q)


def pesq_rows(ref_rows, deg_rows, lengths, fs: int = 16000):
    """(B,) MOS scores for zero-padded (B, L) signal rows (L a multiple of
    512) with (B,) valid lengths.  Traced function -- jit/compose freely.

    Mirrors ``_pesq_model._disturbance_frames`` + ``pesq_mos_aligned``
    stage for stage; see that module for the P.862 citations.
    """
    flen = _FLEN if fs == 16000 else _FLEN // 2
    B = ref_rows.shape[0]

    # --- level alignment (power-domain: scaling x by c scales all powers
    # by c^2, so the factor applies to the frame powers directly)
    p_ref = _masked_hann_power(ref_rows, lengths, fs, _ALIGN_FLEN, 350., 3250.)
    p_deg = _masked_hann_power(deg_rows, lengths, fs, _ALIGN_FLEN, 350., 3250.)
    factor_r = 1e7 / jnp.maximum(p_ref, 1e-12)  # (B,)
    factor_d = 1e7 / jnp.maximum(p_deg, 1e-12)

    # --- Hann 512/256 spectra, wideband input weight
    w = jnp.asarray(np.hanning(flen).astype(np.float32))
    fr_r = _hop_frames(ref_rows, flen)  # (B, T, flen)
    fr_d = _hop_frames(deg_rows, flen)
    T = fr_r.shape[1]
    rf = jnp.fft.rfft(fr_r * w, axis=-1)
    df = jnp.fft.rfft(fr_d * w, axis=-1)
    f = np.linspace(0, fs / 2, flen // 2 + 1)
    wb = jnp.asarray(_wb_input_weight(f).astype(np.float32))
    rp = (jnp.abs(rf) ** 2) * wb * factor_r[:, None, None]
    dp = (jnp.abs(df) ** 2) * wb * factor_d[:, None, None]

    m = jnp.maximum((lengths - flen) // (flen // 2) + 1, 0)  # (B,) frames
    tv = (jnp.arange(T)[None, :] < m[:, None])  # (B, T) frame-valid
    tvf = tv.astype(jnp.float32)

    # --- Bark pitch power densities
    M = jnp.asarray(_band_matrix(fs, flen).astype(np.float32))  # (49, F)
    norm = np.float32(_SP * _POWER_SCALE / np.mean(np.hanning(flen) ** 2))
    rb = jnp.einsum("btf,nf->btn", rp, M,
                precision=jax.lax.Precision.HIGHEST) * norm  # (B, T, 49)
    db = jnp.einsum("btf,nf->btn", dp, M,
                    precision=jax.lax.Precision.HIGHEST) * norm
    rb = rb * tvf[:, :, None]  # zero the padded frames
    db = db * tvf[:, :, None]

    thresh = jnp.asarray(_ABS_THRESH.astype(np.float32))

    def total_audible(pp, factor=1.0):
        return jnp.sum(jnp.where(pp > thresh * factor, pp, 0.0), axis=-1)

    # --- speech-active frames for the compensation averages
    audible_ref = total_audible(rb, 100.0)  # (B, T)
    primary = (audible_ref > 1e7) & tv
    n_primary = jnp.sum(primary, axis=-1)  # (B,)
    rbsum = jnp.sum(rb, axis=-1)
    peak = jnp.max(jnp.where(tv, rbsum, 0.0), axis=-1, keepdims=True)
    fallback = (rbsum > peak * 1e-4) & tv
    n_fallback = jnp.sum(fallback, axis=-1)
    use_primary = (n_primary >= 4)[:, None]
    active = jnp.where(use_primary, primary, fallback)
    n_active = jnp.where(use_primary[:, 0], n_primary, n_fallback)
    invalid = (m < 4) | (n_active < 4)  # host path returns NaN here

    af = active.astype(jnp.float32)
    cnt = jnp.maximum(n_active.astype(jnp.float32), 1.0)[:, None]

    # --- partial frequency compensation of the reference
    mean_r = jnp.einsum("btn,bt->bn", rb, af,
                    precision=jax.lax.Precision.HIGHEST) / cnt
    mean_d = jnp.einsum("btn,bt->bn", db, af,
                        precision=jax.lax.Precision.HIGHEST) / cnt
    ratio = jnp.clip((mean_d + 1000.0) / (mean_r + 1000.0), 0.01, 100.0)
    rb_eq = rb * ratio[:, None, :]

    # --- smoothed short-term gain compensation (first-order scan over t)
    raw = jnp.clip(
        (total_audible(db) + 5e3) / (total_audible(rb_eq) + 5e3), 3e-4, 5.0
    )  # (B, T)

    def smooth_step(s, r_t):
        s = 0.2 * s + 0.8 * r_t
        return s, s

    _, scale = jax.lax.scan(smooth_step, jnp.ones((B,), jnp.float32),
                            jnp.swapaxes(raw, 0, 1))
    rb_eq = rb_eq * jnp.swapaxes(scale, 0, 1)[:, :, None]

    # --- modified Zwicker loudness
    gam = jnp.asarray(_GAMMA.astype(np.float32))

    def loudness(pp):
        l = _SL * (thresh / 0.5) ** gam * ((0.5 + 0.5 * pp / thresh) ** gam - 1.0)
        return jnp.maximum(l, 0.0)

    lr = loudness(rb_eq)
    ld = loudness(db)

    # --- deadzone-clipped disturbance + asymmetry
    d = ld - lr
    dead = 0.25 * jnp.minimum(ld, lr)
    d = jnp.where(d > dead, d - dead, jnp.where(d < -dead, d + dead, 0.0))
    asym = ((db + 50.0) / (rb + 50.0)) ** 1.2
    asym = jnp.where(asym < 3.0, 0.0, jnp.minimum(asym, 12.0))

    bw = jnp.asarray(_WIDTH.astype(np.float32))
    wtot = np.float32(np.sum(_WIDTH))
    d_sym = jnp.sqrt(jnp.sum((d * bw) ** 2, axis=-1) / wtot) * wtot  # (B, T)
    d_asym = jnp.sum(jnp.abs(d) * asym * bw, axis=-1)

    h = ((audible_ref + 1e5) / 1e7) ** 0.04

    d_sym = jnp.minimum(_SYM_SCALE * d_sym / h, 45.0) * tvf
    d_asym = jnp.minimum(_ASYM_SCALE * d_asym / h, 45.0) * tvf
    D = _masked_lpq(d_sym, m)
    DA = _masked_lpq(d_asym, m)
    mos = jnp.clip(4.5 - 0.1 * D - 0.0309 * DA, -0.5, 4.5)
    return jnp.where(invalid, jnp.nan, mos)


@partial(jax.jit, static_argnames=("L", "fs"))
def _pesq_packed_dev(ref_c, deg_c, offsets, lengths, L, fs):
    from .fused import _unpack

    ref_rows = _unpack(ref_c, offsets, lengths, L)
    deg_rows = _unpack(deg_c, offsets, lengths, L)
    return pesq_rows(ref_rows, deg_rows, lengths, fs=fs)


def pesq_packed(ref_list, deg_list, fs: int = 16000):
    """(n_files,) PESQ MOS, batched on device: per pow2-length bucket, ONE
    exact-bytes packed transfer + ONE vmapped program (the packed-engine
    convention of fused.fused_metrics_packed)."""
    n_files = len(ref_list)
    out = np.full(n_files, np.nan)
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (r, dsig) in enumerate(zip(ref_list, deg_list)):
        lens[i] = min(len(r), len(dsig))
        L = max(_next_pow2(lens[i]), 1024)
        buckets.setdefault(L, []).append(i)
    pending = []
    for L, idxs in sorted(buckets.items()):
        ref_c, deg_c, offsets = pack_pair(ref_list, deg_list, idxs, lens)
        res = _pesq_packed_dev(
            jnp.asarray(ref_c), jnp.asarray(deg_c),
            jnp.asarray(offsets),
            jnp.asarray(lens[idxs], np.int32), L=L, fs=fs)
        pending.append((idxs, res))  # dispatch all buckets before fetching
    for idxs, res in pending:
        out[np.asarray(idxs)] = np.asarray(res)
    return out

"""Fully on-device STOI: resampling + silent-frame removal + correlations.

Device port of the HOST stage of ``stoi.py`` (resample to 10 kHz, remove
frames >40 dB below the loudest, overlap-add survivors -- previously scipy
+ numpy per file on a thread pool) fused with its packed device stage, so
a whole bucket of files runs as one program with no host math at all
(SURVEY §2: on-device equivalents).

* Resampling 16 kHz -> 10 kHz is scipy.signal.resample_poly's exact
  polyphase scheme (up=5/down=8, firwin kaiser-5.0 filter of half-length
  800) expressed as ONE `lax.conv_general_dilated` (lhs_dilation=up,
  stride=down) -- measured equal to scipy to float32 roundoff.
* Silent-frame removal keeps the canonical semantics: windowed 256/128
  frames, energy threshold vs the loudest VALID frame, survivors
  overlap-added contiguously.  The variable-length result is built by a
  scatter-add at rank*HOP offsets (out-of-bounds rows drop), keeping every
  shape static.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bss_eval import _next_pow2
from .fused import pack_pair
import scipy.signal

from .stoi import (
    BETA_DB,
    DYN_RANGE_DB,
    FRAME,
    FS_STOI,
    HOP,
    N_FFT,
    SEG_FRAMES,
    _H_BANDS,
)

_UP, _DOWN = 5, 8  # 16 kHz -> 10 kHz


def _design_resampler(up, down):
    """scipy.signal.resample_poly's filter + alignment constants
    (firwin(2*10*max_rate + 1, 1/max_rate, kaiser beta 5.0) * up)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = scipy.signal.firwin(2 * half_len + 1, 1.0 / max_rate,
                            window=("kaiser", 5.0)) * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h_pad = np.concatenate([np.zeros(n_pre_pad), h]).astype(np.float32)
    return h_pad, n_pre_remove


_H_PAD, _N_PRE_REMOVE = _design_resampler(_UP, _DOWN)


def resample_rows_16k_to_10k(rows, lengths):
    """(B, L) zero-padded rows at 16 kHz -> (B, L10) rows at 10 kHz with
    new valid lengths ceil(n*5/8); bitwise the same math as
    scipy.signal.resample_poly(x[:n], 5, 8) (float32)."""
    B, L = rows.shape
    L10 = -(-L * _UP // _DOWN)
    rhs = jnp.asarray(_H_PAD[::-1].copy())
    pad_lo = _H_PAD.shape[0] - 1
    out = jax.lax.conv_general_dilated(
        rows[:, None, :], rhs[None, None, :], window_strides=(_DOWN,),
        padding=[(pad_lo, pad_lo)], lhs_dilation=(_UP,),
        precision=jax.lax.Precision.HIGHEST)
    res = out[:, 0, _N_PRE_REMOVE : _N_PRE_REMOVE + L10]
    if res.shape[1] < L10:  # conv output can end one stride short
        res = jnp.pad(res, ((0, 0), (0, L10 - res.shape[1])))
    n10 = -((-lengths * _UP) // _DOWN)  # ceil(n*up/down)
    # zero anything past each row's own resampled length (the conv tail of
    # the zero padding is exactly zero already, but keep it explicit)
    res = jnp.where(jnp.arange(L10)[None, :] < n10[:, None], res, 0.0)
    return res, n10


def _frame_rows(rows, flen=FRAME):
    hop = flen // 2
    blocks = rows.reshape(rows.shape[0], -1, hop)
    return jnp.concatenate([blocks[:, :-1], blocks[:, 1:]], axis=-1)


def stoi_rows(ref_rows, est_rows, lengths, fs: int = 16000):
    """(B,) STOI scores from zero-padded (B, L) rows + (B,) lengths, all on
    device.  ``fs`` must be 16000 (resampled on device) or 10000."""
    if fs == 16000:
        ref10, n10 = resample_rows_16k_to_10k(ref_rows, lengths)
        est10, _ = resample_rows_16k_to_10k(est_rows, lengths)
    elif fs == FS_STOI:
        ref10, est10, n10 = ref_rows, est_rows, lengths
    else:
        raise ValueError(f"device STOI supports fs 16000/10000, got {fs}")
    B, L10 = ref10.shape
    pad = (-L10) % HOP
    if pad:
        ref10 = jnp.pad(ref10, ((0, 0), (0, pad)))
        est10 = jnp.pad(est10, ((0, 0), (0, pad)))
        L10 += pad

    w = jnp.asarray(np.hanning(FRAME + 2)[1:-1].astype(np.float32))
    xf = _frame_rows(ref10) * w  # (B, T, FRAME)
    yf = _frame_rows(est10) * w
    T = xf.shape[1]
    m = jnp.maximum((n10 - FRAME) // HOP + 1, 0)  # (B,) valid frames
    tv = jnp.arange(T)[None, :] < m[:, None]

    # --- silent-frame removal (clean-signal energy criterion)
    energy = 20.0 * jnp.log10(
        jnp.sqrt(jnp.sum(xf * xf, axis=-1)) + 1e-30)  # (B, T)
    peak = jnp.max(jnp.where(tv, energy, -np.inf), axis=-1, keepdims=True)
    keep = (energy > peak - DYN_RANGE_DB) & tv
    m2 = jnp.sum(keep, axis=-1)  # (B,) surviving frames

    # overlap-add survivors contiguously: frame of rank k lands at k*HOP;
    # dropped frames scatter out of bounds (mode='drop')
    ranks = jnp.cumsum(keep, axis=-1) - 1
    starts = jnp.where(keep, ranks * HOP, L10)  # L10 == OOB sentinel
    idx = starts[:, :, None] + jnp.arange(FRAME)[None, None, :]

    def ola(fr, ix):
        return jnp.zeros((L10,), jnp.float32).at[ix.reshape(-1)].add(
            fr.reshape(-1), mode="drop")

    xs = jax.vmap(ola)(xf, idx)  # (B, L10)
    ys = jax.vmap(ola)(yf, idx)

    # --- band envelopes of the re-framed survivors
    xf2 = _frame_rows(xs) * w
    yf2 = _frame_rows(ys) * w
    spec_x = jnp.fft.rfft(xf2, n=N_FFT, axis=-1)
    spec_y = jnp.fft.rfft(yf2, n=N_FFT, axis=-1)
    Hb = jnp.asarray(_H_BANDS)
    xb = jnp.sqrt(jnp.einsum("btf,nf->bnt", jnp.abs(spec_x) ** 2, Hb,
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32))
    yb = jnp.sqrt(jnp.einsum("btf,nf->bnt", jnp.abs(spec_y) ** 2, Hb,
                             precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32))

    # --- segment correlations (the packed device stage of stoi.py)
    n_seg = xb.shape[2] - SEG_FRAMES + 1
    sidx = jnp.arange(n_seg)[:, None] + jnp.arange(SEG_FRAMES)[None, :]
    xsg = xb[:, :, sidx]  # (B, NB, n_seg, S)
    ysg = yb[:, :, sidx]
    alpha = jnp.sqrt(
        jnp.sum(xsg**2, axis=-1, keepdims=True)
        / jnp.maximum(jnp.sum(ysg**2, axis=-1, keepdims=True), 1e-30))
    ys_c = jnp.minimum(ysg * alpha, xsg * (1.0 + 10.0 ** (-BETA_DB / 20.0)))
    xm = xsg - jnp.mean(xsg, axis=-1, keepdims=True)
    ym = ys_c - jnp.mean(ys_c, axis=-1, keepdims=True)
    num = jnp.sum(xm * ym, axis=-1)
    den = jnp.sqrt(jnp.sum(xm**2, axis=-1) * jnp.sum(ym**2, axis=-1))
    d = num / jnp.maximum(den, 1e-30)  # (B, NB, n_seg)

    seg_means = jnp.mean(d, axis=1)  # (B, n_seg)
    valid = (jnp.arange(n_seg)[None, :]
             < (m2[:, None] - SEG_FRAMES + 1)).astype(jnp.float32)
    score = (jnp.sum(seg_means * valid, axis=1)
             / jnp.maximum(jnp.sum(valid, axis=1), 1.0))
    return jnp.where(m2 < SEG_FRAMES, jnp.nan, score)


@partial(jax.jit, static_argnames=("L", "fs"))
def _stoi_rows_packed_dev(ref_c, est_c, offsets, lengths, L, fs):
    from .fused import _unpack

    ref_rows = _unpack(ref_c, offsets, lengths, L)
    est_rows = _unpack(est_c, offsets, lengths, L)
    return stoi_rows(ref_rows, est_rows, lengths, fs=fs)


def stoi_packed_device(ref_list, est_list, fs: int = 16000):
    """(n_files,) STOI, entirely on device (vs stoi.stoi_packed whose
    resample + silent-removal stage ran on a host pool)."""
    n_files = len(ref_list)
    out = np.full(n_files, np.nan)
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (r, e) in enumerate(zip(ref_list, est_list)):
        lens[i] = min(len(r), len(e))
        L = max(_next_pow2(lens[i]), 1024)
        buckets.setdefault(L, []).append(i)
    pending = []
    for L, idxs in sorted(buckets.items()):
        ref_c, est_c, offsets = pack_pair(ref_list, est_list, idxs, lens)
        res = _stoi_rows_packed_dev(
            jnp.asarray(ref_c), jnp.asarray(est_c),
            jnp.asarray(offsets),
            jnp.asarray(lens[idxs], np.int32), L=L, fs=fs)
        pending.append((idxs, res))
    for idxs, res in pending:
        out[np.asarray(idxs)] = np.asarray(res)
    return out

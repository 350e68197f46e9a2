"""BSS-Eval SDR, on device.

Reimplements the single-source case of BSS Eval 3.0's ``bss_eval_sources``
(the metric the reference computes through MATLAB, score_audio.m:206): the
estimate is decomposed as ``se = s_target + e_artif`` where ``s_target`` is
the least-squares projection of ``se`` onto the subspace spanned by 512-tap
delayed versions of the reference signal, and

    SDR = 10 log10( ||s_target||^2 / ||se - s_target||^2 ).

Computation (all jit'd, vmappable over utterances):

* autocorrelation of the reference and cross-correlation via rFFT
  (O(n log n) instead of the naive O(n L)),
* the L x L symmetric Toeplitz normal-equations solve via Cholesky on the
  device (L=512 -- a single well-shaped linalg call),
* the projection filter applied by FFT convolution.

float32 conditioning: a small diagonal loading (relative ~1e-7) keeps the
Cholesky stable; parity with a float64 host reference is asserted in tests
to ~0.01 dB, well inside the 0.1 dB budget.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

FLEN = 512


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


@partial(jax.jit, static_argnames=("flen",))
def _sdr_padded(se, s, n_valid, flen=FLEN, ridge=1e-7):
    """se, s: zero-padded (nfft,) float32; n_valid: true length (traced ok)."""
    nfft = se.shape[-1]
    sf = jnp.fft.rfft(s)
    sef = jnp.fft.rfft(se)

    # autocorrelation r[k] = sum_t s[t] s[t-k]
    r = jnp.fft.irfft(sf * jnp.conj(sf), n=nfft)[:flen]
    # cross-correlation c[k] = sum_t se[t] s[t-k]
    c = jnp.fft.irfft(sef * jnp.conj(sf), n=nfft)[:flen]

    # symmetric Toeplitz normal matrix built from r (no data-dependent shapes)
    idx = jnp.abs(
        jax.lax.broadcasted_iota(jnp.int32, (flen, flen), 0)
        - jax.lax.broadcasted_iota(jnp.int32, (flen, flen), 1)
    )
    R = r[idx] + (ridge * r[0] + 1e-30) * jnp.eye(flen, dtype=r.dtype)

    h = jax.scipy.linalg.solve(R, c, assume_a="pos")

    # s_target = h * s (filter), truncated to n_valid + flen - 1 like bss_eval
    hf = jnp.fft.rfft(h, n=nfft)
    s_target = jnp.fft.irfft(hf * sf, n=nfft)
    t = jnp.arange(nfft)
    proj_mask = t < (n_valid + flen - 1)
    s_target = jnp.where(proj_mask, s_target, 0.0)
    e = jnp.where(proj_mask, se - s_target, 0.0)

    num = jnp.sum(s_target * s_target)
    den = jnp.sum(e * e)
    return 10.0 * jnp.log10(num / jnp.maximum(den, 1e-30))


def bss_eval_sdr(se, s, flen: int = FLEN) -> float:
    """SDR of estimate ``se`` against reference ``s`` (1-D arrays)."""
    se = np.asarray(se, np.float32).ravel()
    s = np.asarray(s, np.float32).ravel()
    n = min(len(se), len(s))
    se, s = se[:n], s[:n]
    nfft = _next_pow2(n + flen)
    pad = nfft - n
    se_p = jnp.asarray(np.pad(se, (0, pad)))
    s_p = jnp.asarray(np.pad(s, (0, pad)))
    # Near-periodic references make the Toeplitz system rank-deficient in
    # float32; escalate the relative ridge until the solve is finite.  The
    # bias of the ridge on well-conditioned signals is < 0.01 dB (tested).
    for ridge in (1e-7, 1e-5, 1e-3):
        val = float(_sdr_padded(se_p, s_p, jnp.int32(n), flen=flen, ridge=ridge))
        if np.isfinite(val):
            return val
    return val


def bss_eval_sdr_batch(ses, ss, lengths, flen: int = FLEN):
    """vmapped SDR over a padded batch: (B, nfft) arrays + (B,) lengths."""
    fn = jax.vmap(partial(_sdr_padded, flen=flen))
    return fn(jnp.asarray(ses), jnp.asarray(ss), jnp.asarray(lengths))


def bss_eval_sdr_many(est_list, ref_list, flen: int = FLEN):
    """SDR for many (est, ref) pairs, batched per power-of-two FFT bucket.

    Library utility for vmapped consumers; the scoring engine does not use
    it (it packs all six metrics into one program per bucket instead, see
    metrics/engine.py).  Non-finite entries (the rare
    rank-deficient references) are retried per file with the escalating
    ridge of :func:`bss_eval_sdr`."""
    n_files = len(est_list)
    out = np.zeros(n_files, np.float64)
    buckets = {}
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        n = min(len(se), len(s))
        buckets.setdefault(_next_pow2(n + flen), []).append(i)
    for nfft, idxs in sorted(buckets.items()):
        ses = np.zeros((len(idxs), nfft), np.float32)
        ss = np.zeros((len(idxs), nfft), np.float32)
        lengths = np.zeros(len(idxs), np.int32)
        for row, i in enumerate(idxs):
            n = min(len(est_list[i]), len(ref_list[i]))
            ses[row, :n] = np.asarray(est_list[i][:n], np.float32)
            ss[row, :n] = np.asarray(ref_list[i][:n], np.float32)
            lengths[row] = n
        vals = np.asarray(bss_eval_sdr_batch(ses, ss, lengths, flen=flen))
        for row, i in enumerate(idxs):
            out[i] = (
                vals[row] if np.isfinite(vals[row])
                else bss_eval_sdr(est_list[i], ref_list[i], flen=flen)
            )
    return out

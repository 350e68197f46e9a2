"""Phase-augmented STFT features (the reference's optional unwrap path).

Behavioral spec (reference, do-not-copy — reimplemented in JAX):

* ``AugSTFT`` (util.py:228-243): STFT of the first channel, optionally with
  *window-hop phases removed*: the phase is unwrapped along the frame axis,
  re-adjusted so that re-wrapping reproduces the original angles exactly, and
  then the linear term ``2*pi*(f/N)*(t*hop)`` (the phase advance a stationary
  sinusoid accrues per hop) is subtracted.  The result is returned as a
  real-composite array ``[real; imag]``.
* ``iAugSTFT`` (util.py:245-281): splits a ``(2*nsrc*nch*F, nfram)``
  real-composite array into complex per-source spectrograms, optionally adds
  the hop phases back, and inverse-STFTs each source.
* ``compute_STFTs(..., flag_unwrap_phase=True)`` (util.py:338-344) applies the
  same hop-phase removal per file before stacking.

The phase ops are pure jnp (``jnp.unwrap`` runs as an on-device
cumsum) over frame-major (..., n_frames, F) spectrograms, jit/vmap-safe.
"""

import jax.numpy as jnp
import numpy as np

from .stft import stft, istft
from .windows import sqrt_hann_periodic


def _hop_phase(n_frames: int, f_bins: int, n_fft: int, hop: int) -> jnp.ndarray:
    """Linear phase advance 2*pi*(f/N)*(t*hop), shape (n_frames, f_bins)."""
    frange = jnp.arange(f_bins, dtype=jnp.float32) / jnp.float32(n_fft)
    trange = jnp.arange(n_frames, dtype=jnp.float32) * jnp.float32(hop)
    return 2.0 * jnp.pi * trange[:, None] * frange[None, :]


def remove_hop_phase(spec: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """Unwrap phase over frames and remove window-hop phases.

    ``spec``: complex (..., n_frames, F).  Mirrors util.py:234-242: after
    unwrapping, the phase is corrected by the rewrap error so that
    ``angle(exp(1j*phase)) == angle(spec)`` holds exactly before the linear
    hop term is subtracted.
    """
    ang = jnp.angle(spec)
    phase = jnp.unwrap(ang.astype(jnp.float32), axis=-2)
    err = jnp.angle(jnp.exp(1j * phase)) - ang
    phase = phase - err
    phase = phase - _hop_phase(spec.shape[-2], spec.shape[-1], n_fft, hop)
    return (jnp.abs(spec) * jnp.exp(1j * phase)).astype(jnp.complex64)


def add_hop_phase(spec: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """Inverse of :func:`remove_hop_phase` up to phase wrapping
    (util.py:266-272)."""
    phase = jnp.angle(spec).astype(jnp.float32)
    phase = phase + _hop_phase(spec.shape[-2], spec.shape[-1], n_fft, hop)
    return (jnp.abs(spec) * jnp.exp(1j * phase)).astype(jnp.complex64)


def aug_stft(x, n_fft: int, hop: int, flag_unwrap_phase: bool = False,
             window=None) -> np.ndarray:
    """Augmented STFT of a (possibly multichannel) signal's first channel.

    Returns the reference's real-composite layout ``(2F, n_frames)``
    (util.py:228-243).
    """
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[0]
    if window is None:
        window = sqrt_hann_periodic(n_fft)
    spec = stft(jnp.asarray(x), n_fft, hop, jnp.asarray(window))  # (T, F)
    if flag_unwrap_phase:
        spec = remove_hop_phase(spec, n_fft, hop)
    spec = np.asarray(spec).T  # (F, T)
    return np.concatenate([spec.real, spec.imag], axis=0).astype(np.float32)


def iaug_stft(X, f_bins: int, nsrc: int, flag_unwrap_phase: bool = False,
              window=None, hop=None) -> np.ndarray:
    """Reconstruct time series from an augmented STFT.

    ``X``: real-composite ``(2*nsrc*nch*F, n_frames)``.  Returns
    ``(nsrc, nsampl, nch)`` float32 (util.py:245-281).
    """
    X = np.asarray(X, np.float32)
    n_fft = 2 * (f_bins - 1)
    if hop is None:
        hop = n_fft // 2
    if window is None:
        window = sqrt_hann_periodic(n_fft)
    n_reim = X.shape[0] // 2
    n_frames = X.shape[1]
    Xc = X[:n_reim] + 1j * X[n_reim:]
    nch = n_reim // (nsrc * f_bins)
    out = None
    for isrc in range(nsrc):
        xs = Xc[isrc * nch * f_bins : (isrc + 1) * nch * f_bins]
        # (nch*F, T) stored channel-major like compute_STFTs -> (nch, F, T)
        xs = xs.reshape(f_bins, nch, n_frames, order="F")
        spec = jnp.asarray(np.transpose(xs, (1, 2, 0)).astype(np.complex64))
        if flag_unwrap_phase:
            spec = add_hop_phase(spec, n_fft, hop)
        xr = np.asarray(istft(spec, n_fft, hop, jnp.asarray(window)))  # (nch, n)
        if out is None:
            out = np.zeros((nsrc, xr.shape[1], nch), np.float32)
        out[isrc] = xr.T
    return out

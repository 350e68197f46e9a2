"""STFT / iSTFT primitives, bit-matching the reference's conventions.

Reference semantics being reproduced (see /root/reference for parity checks,
do-not-copy -- these are behavioral specs, the code below is JAX-native):

* ``stft_mc`` (util.py:171-201): the signal is zero-padded up to a multiple of
  ``hop``, then padded with ``n_fft`` zeros on *both* edges (to kill window
  taper effects), then framed left-aligned (librosa ``center=False``) and
  transformed with an rFFT after windowing.  Frame count is
  ``1 + (padded_len - n_fft) // hop``.

* ``istft_noDiv`` (util.py:48-169): inverse STFT *without* the squared-window
  -sum normalization; instead the synthesis window is the analysis window
  scaled by ``2 / (n_fft / hop)`` (util.py:143), followed by plain
  overlap-add.  For the sqrt-Hann analysis/synthesis pair at 75% overlap this
  yields exact unity OLA gain.

* ``istft_mc`` (util.py:203-226): after overlap-add, ``n_fft`` samples are
  trimmed from both ends (undoing the edge padding), then the result is cut
  to ``nsampl``.

Design notes:

* Framing uses a hop-block reshape + static concatenation instead of a
  gather: when ``n_fft % hop == 0`` (true for every config the reference
  ships: 512/128, 320/160, 1024/512), a frame is exactly ``n_fft//hop``
  consecutive hop-blocks, so framing is ``n_fft//hop`` static slices of a
  ``(n_blocks, hop)`` reshape.  XLA fuses these into cheap copies; no
  dynamic-shape ops, everything jit-stable for a fixed padded length.

* Batched: all functions accept leading batch dims and are jit/vmap-safe.

* Length buckets: callers pad signals up to a bucket length; because framing
  is left-aligned and the reference's own padding is zeros, the first
  ``n_frames_for_length(true_len)`` frames of a longer zero-padded signal are
  identical to the reference's frames, so one compiled program serves many
  utterance lengths.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .windows import sqrt_hann_periodic


def padded_length(nsampl: int, n_fft: int, hop: int) -> int:
    """Total length after reference-style padding (multiple-of-hop + edge pads)."""
    n_blocks = -(-nsampl // hop)  # ceil
    return n_blocks * hop + 2 * n_fft


SAMPLE_BUCKET = 32768  # ~2 s at 16 kHz: one compiled program per bucket


def bucket_total(nsampl: int, n_fft: int, hop: int,
                 bucket: int = SAMPLE_BUCKET) -> int:
    """padded_length rounded up to the sample-bucket grid (bounds the
    number of compiled programs across a corpus of arbitrary lengths).

    The grid is linear (1, 2, 3, 4 buckets) up to 4 buckets, then
    half-octave geometric (4, 6, 8, 12, 16, 24, ... buckets): each distinct
    shape is one more compiled program, so at corpus scale the grid trades
    a bounded padding waste (at most 33% on the geometric arm) for a
    program count that grows with the log of the longest utterance.
    Padded frames past a file's true count are discarded by the callers
    (fidx / per-file nframes)."""
    n = -(-padded_length(nsampl, n_fft, hop) // bucket)
    if n > 4:
        # next value in {4, 6, 8, 12, 16, 24, ...}: pow2 and 1.5*pow2
        p = 4
        while p < n:
            if p + p // 2 >= n:
                p = p + p // 2
                break
            p *= 2
        n = max(p, n)  # (p >= n by construction; max is belt-and-braces)
    return n * bucket


def n_frames_for_length(nsampl: int, n_fft: int, hop: int) -> int:
    """Number of STFT frames the reference produces for a raw signal length."""
    total = padded_length(nsampl, n_fft, hop)
    return 1 + (total - n_fft) // hop


def _frame(x: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """Frame a pre-padded signal (..., total) -> (..., n_frames, n_fft).

    Requires ``total`` such that ``(total - n_fft) % hop == 0`` for exact
    coverage; trailing remainder samples are dropped (librosa center=False
    behavior).
    """
    total = x.shape[-1]
    n_frames = 1 + (total - n_fft) // hop
    if n_fft % hop == 0:
        ratio = n_fft // hop
        usable = (n_frames - 1 + ratio) * hop
        blocks = x[..., :usable].reshape(*x.shape[:-1], usable // hop, hop)
        parts = [
            jax.lax.slice_in_dim(blocks, k, k + n_frames, axis=blocks.ndim - 2)
            for k in range(ratio)
        ]
        return jnp.concatenate(parts, axis=-1)
    # Fallback for non-divisor hops: gather-based framing.
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return x[..., idx]


@partial(jax.jit, static_argnames=("n_fft", "hop"))
def stft_frames(x: jnp.ndarray, window: jnp.ndarray, n_fft: int,
                hop: int) -> jnp.ndarray:
    """STFT of a *pre-padded* signal.  (..., total) -> (..., n_frames, n_fft//2+1).

    The caller applies reference-style padding (see :func:`pad_signal`).
    Output is complex64, frames along the second-to-last axis and frequency
    on the last axis.
    """
    frames = _frame(x.astype(jnp.float32), n_fft, hop)
    frames = frames * window.astype(jnp.float32)
    return jnp.fft.rfft(frames, axis=-1).astype(jnp.complex64)


def pad_signal(x: jnp.ndarray, n_fft: int, hop: int, total: int | None = None) -> jnp.ndarray:
    """Reference-style padding: round up to hop multiple, add n_fft both edges.

    If ``total`` is given, additionally right-pad with zeros to ``total``
    (length-bucketing; extra frames are sliced off by the caller).
    """
    nsampl = x.shape[-1]
    base = padded_length(nsampl, n_fft, hop)
    if total is None:
        total = base
    if total < base:
        raise ValueError(f"bucket length {total} < required padded length {base}")
    pad = [(0, 0)] * (x.ndim - 1) + [(n_fft, total - n_fft - nsampl)]
    return jnp.pad(x, pad)


def stft(x: jnp.ndarray, n_fft: int = 512, hop: int = 128,
         window: jnp.ndarray | None = None) -> jnp.ndarray:
    """Full reference-semantics STFT: pad + frame + window + rFFT.

    (..., nsampl) -> (..., n_frames, F) complex64 with F = n_fft//2 + 1.
    Equivalent to the reference's ``stft_mc`` (util.py:171-201) transposed to
    frame-major layout.
    """
    if window is None:
        window = jnp.asarray(sqrt_hann_periodic(n_fft))
    xp = pad_signal(jnp.asarray(x), n_fft, hop)
    return stft_frames(xp, jnp.asarray(window), n_fft, hop)


@partial(jax.jit, static_argnames=("hop",))
def overlap_add(frames: jnp.ndarray, hop: int) -> jnp.ndarray:
    """Overlap-add synthesis.  (..., n_frames, n_fft) -> (..., n_fft + hop*(n_frames-1)).

    Uses hop-block accumulation (n_fft//hop static scatter-free adds) when
    ``n_fft % hop == 0``.
    """
    n_frames, n_fft = frames.shape[-2], frames.shape[-1]
    out_len = n_fft + hop * (n_frames - 1)
    if n_fft % hop == 0:
        ratio = n_fft // hop
        fb = frames.reshape(*frames.shape[:-1], ratio, hop)
        acc = jnp.zeros((*frames.shape[:-2], n_frames + ratio - 1, hop), frames.dtype)
        for k in range(ratio):
            acc = acc.at[..., k : k + n_frames, :].add(fb[..., k, :])
        return acc.reshape(*frames.shape[:-2], (n_frames + ratio - 1) * hop)[..., :out_len]
    # Fallback: index_add per frame (rarely used).
    y = jnp.zeros((*frames.shape[:-2], out_len), frames.dtype)
    for i in range(n_frames):
        y = y.at[..., i * hop : i * hop + n_fft].add(frames[..., i, :])
    return y


@partial(jax.jit, static_argnames=("n_fft", "hop"))
def istft_frames(spec: jnp.ndarray, window: jnp.ndarray, n_fft: int,
                 hop: int) -> jnp.ndarray:
    """Inverse STFT, no window-sum division (reference istft_noDiv semantics).

    (..., n_frames, F) -> (..., n_fft + hop*(n_frames-1)).
    The synthesis window is ``window * 2/(n_fft/hop)`` (util.py:143).
    """
    scale = 2.0 / (float(n_fft) / float(hop))
    syn = window.astype(jnp.float32) * jnp.float32(scale)
    frames = jnp.fft.irfft(spec, n=n_fft, axis=-1).astype(jnp.float32)
    return overlap_add(frames * syn, hop)


def istft(spec: jnp.ndarray, n_fft: int = 512, hop: int = 128,
          window: jnp.ndarray | None = None, nsampl: int | None = None) -> jnp.ndarray:
    """Full reference-semantics iSTFT: irFFT + OLA + edge trim + length cut.

    Mirrors ``istft_mc(..., flag_noDiv=1)`` (util.py:203-226): trims ``n_fft``
    samples from each end (the analysis edge pads), then cuts to ``nsampl``.
    """
    if window is None:
        window = jnp.asarray(sqrt_hann_periodic(n_fft))
    y = istft_frames(jnp.asarray(spec), jnp.asarray(window), n_fft, hop)
    y = y[..., n_fft:-n_fft] if y.shape[-1] > 2 * n_fft else y[..., :0]
    if nsampl is not None:
        y = y[..., :nsampl]
    return y

"""Fused batch enhancement: waveform in, enhanced waveform out, one program.

The highest-throughput serving path (the one bench.py measures): STFT
featurization, the DR-NMF recurrence, the Wiener-style ratio mask, and the
overlap-add iSTFT compiled into a single XLA program over a batch of
equal-padded utterances -- no intermediate host round-trips.  For
online/low-latency use see :mod:`drnmf_tpu.streaming`; for the
full experiment flow (caches, scoring) see :mod:`drnmf_tpu.pipeline`.
"""

import jax
import jax.numpy as jnp

from .dsp.stft import stft_frames, istft_frames, bucket_total
from .dsp.windows import sqrt_hann_periodic
from .models.drnmf import DRNMFConfig, drnmf_forward


def make_enhancer(config: DRNMFConfig, n_fft: int = 512, hop: int = 128):
    """Returns a jitted ``enhance(params, wav_padded) -> wav_enhanced``.

    ``wav_padded``: (B, total) float32, already padded with
    :func:`drnmf_tpu.dsp.stft.pad_signal` (callers bucket by padded length so
    a handful of compiled programs serve a whole corpus).  The output has the
    same length; slice ``[n_fft:-n_fft][:nsampl]`` per utterance to undo the
    edge pads (or use :func:`enhance_signals`).
    """
    window = jnp.asarray(sqrt_hann_periodic(n_fft))

    @jax.jit
    def enhance(params, wav):
        spec = stft_frames(wav, window, n_fft, hop)  # (B, T, F) complex64
        mag = jnp.abs(spec)
        irm = drnmf_forward(params, config, mag)
        return istft_frames(spec * irm.astype(spec.dtype), window, n_fft, hop)

    return enhance


def enhance_signals(params, config: DRNMFConfig, signals, n_fft: int = 512,
                    hop: int = 128, batch_size: int = 128):
    """Enhance a list of 1-D float32 signals; returns same-length arrays.

    Convenience wrapper: pads each signal to the batch's max padded length,
    runs :func:`make_enhancer` in batches, trims the edge pads and the
    per-signal length.
    """
    import numpy as np

    enhance = make_enhancer(config, n_fft, hop)
    out = []
    for start in range(0, len(signals), batch_size):
        chunk = signals[start : start + batch_size]
        # shared sample-bucket grid (zero tail enhances to zeros); the
        # batch is padded on the host, so it crosses to the device as one
        # transfer instead of one pad program per signal
        total = max(bucket_total(len(s), n_fft, hop) for s in chunk)
        batch_np = np.zeros((len(chunk), total), np.float32)
        for row, s in enumerate(chunk):
            x = np.asarray(s, np.float32)
            batch_np[row, n_fft : n_fft + x.shape[-1]] = x
        batch = jnp.asarray(batch_np)
        y = np.asarray(enhance(params, batch))
        for row, s in zip(y, chunk):
            out.append(row[n_fft:-n_fft][: len(s)])
    return out

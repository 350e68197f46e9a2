"""DSP core tests: STFT/iSTFT parity with the reference's conventions.

The reference's only numeric oracle here is the STFT->iSTFT round-trip NMSE
(~1e-7, test_audio_dataset.py:83).  We additionally compare frame-for-frame
with the plain numpy transcription of the exact reference pipeline
(librosa-0.5.1-era framing + istft_noDiv overlap-add) in
drnmf_tpu/reference.py.
"""

import numpy as np
import pytest

from drnmf_tpu.dsp import (
    hann_periodic,
    sqrt_hann_periodic,
    stft,
    istft,
    n_frames_for_length,
)
from drnmf_tpu.dsp.stft import pad_signal, stft_frames, padded_length
from drnmf_tpu.reference import ref_istft, ref_stft


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (320, 160), (1024, 512)])
def test_stft_matches_reference_transcription(rng, n_fft, hop):
    x = rng.standard_normal(9001).astype(np.float32)
    w = sqrt_hann_periodic(n_fft)
    ours = np.asarray(stft(x, n_fft, hop, w))  # (n_frames, F)
    ref = ref_stft(x, n_fft, hop, w)  # (F, n_frames)
    assert ours.shape == (ref.shape[1], ref.shape[0])
    np.testing.assert_allclose(ours.T, ref, rtol=0, atol=2e-4)


def test_n_frames_formula(rng):
    for nsampl in [1, 127, 128, 129, 9001, 16000 * 3]:
        x = np.zeros(nsampl, dtype=np.float32)
        assert stft(x, 512, 128).shape[0] == n_frames_for_length(nsampl, 512, 128)


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (320, 160)])
def test_roundtrip_nmse(rng, n_fft, hop):
    """STFT -> iSTFT round trip NMSE at the reference's ~1e-7 level."""
    nsampl = 16000 * 2 + 37
    x = rng.standard_normal(nsampl).astype(np.float32) * 0.1
    w = sqrt_hann_periodic(n_fft)
    spec = stft(x, n_fft, hop, w)
    # istft expects (..., n_frames, F)
    xr = np.asarray(istft(spec, n_fft, hop, w, nsampl=nsampl))
    nmse = np.mean((x - xr) ** 2) / np.mean(x**2)
    assert nmse < 1e-7, f"round-trip NMSE {nmse:.3e}"


def test_istft_matches_reference_transcription(rng):
    n_fft, hop = 512, 128
    w = sqrt_hann_periodic(n_fft)
    x = rng.standard_normal(20000).astype(np.float32)
    spec_ref = ref_stft(x, n_fft, hop, w)
    ours = np.asarray(istft(np.asarray(spec_ref.T), n_fft, hop, w, nsampl=20000))
    ref = ref_istft(spec_ref, n_fft, hop, w, nsampl=20000)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_bucketed_padding_prefix_equality(rng):
    """Frames from a zero-padded-to-bucket signal match the exact-length
    frames on the true-frame prefix -- the property length bucketing relies on."""
    n_fft, hop = 512, 128
    w = sqrt_hann_periodic(n_fft)
    x = rng.standard_normal(5000).astype(np.float32)
    exact = np.asarray(stft(x, n_fft, hop, w))
    bucket_total = padded_length(8192, n_fft, hop)
    xp = pad_signal(np.asarray(x), n_fft, hop, total=bucket_total)
    bucketed = np.asarray(stft_frames(xp, np.asarray(w), n_fft, hop))
    nf = n_frames_for_length(5000, n_fft, hop)
    np.testing.assert_allclose(bucketed[:nf], exact, rtol=0, atol=1e-6)


def test_windows_match_scipy():
    import scipy.signal

    for n in [320, 512]:
        np.testing.assert_allclose(
            hann_periodic(n),
            scipy.signal.windows.hann(n, sym=False).astype(np.float32),
            atol=1e-7,
        )
        np.testing.assert_allclose(
            sqrt_hann_periodic(n),
            np.sqrt(scipy.signal.windows.hann(n, sym=False)).astype(np.float32),
            atol=1e-7,
        )


def test_batched_stft(rng):
    x = rng.standard_normal((3, 9001)).astype(np.float32)
    w = sqrt_hann_periodic(512)
    batched = np.asarray(stft(x, 512, 128, w))
    for i in range(3):
        single = np.asarray(stft(x[i], 512, 128, w))
        np.testing.assert_allclose(batched[i], single, atol=1e-6)


def test_wav_roundtrip(tmp_path, rng):
    from drnmf_tpu.dsp import wavread, wavwrite

    x = rng.uniform(-0.9, 0.9, size=(1, 8000)).astype(np.float32)
    f = str(tmp_path / "t.wav")
    wavwrite(f, 16000, x)
    xr = wavread(f)
    assert xr.shape == x.shape
    # write scales by 32767 but read divides by 32768 (reference convention),
    # so round-trip error is ~x/32768 + quantization
    np.testing.assert_allclose(xr, x, atol=1e-4)


# ---------------------------------------------------------------------------
# phase-augmented features (reference AugSTFT/iAugSTFT, util.py:228-281)
# ---------------------------------------------------------------------------

def test_hop_phase_remove_add_roundtrip(rng):
    import jax.numpy as jnp
    from drnmf_tpu.dsp import remove_hop_phase, add_hop_phase

    n_fft, hop = 256, 64
    x = rng.standard_normal(4000).astype(np.float32)
    spec = stft(x, n_fft, hop)
    removed = remove_hop_phase(spec, n_fft, hop)
    # magnitudes untouched
    np.testing.assert_allclose(
        np.abs(np.asarray(removed)), np.abs(np.asarray(spec)), rtol=1e-5, atol=1e-6
    )
    # remove -> add recovers the complex spectrogram exactly (the rewrap-error
    # correction makes the unwrap lossless, util.py:235-237)
    # float32 phase accumulation (hop phases reach ~1e4 rad) bounds the
    # roundtrip to ~1e-3 relative, same as the reference's float32 path
    back = add_hop_phase(removed, n_fft, hop)
    err = np.abs(np.asarray(back) - np.asarray(spec))
    scale = np.abs(np.asarray(spec)).max()
    assert err.max() / scale < 5e-3


@pytest.mark.parametrize("unwrap", [False, True])
def test_aug_stft_time_domain_roundtrip(rng, unwrap):
    from drnmf_tpu.dsp import aug_stft, iaug_stft

    n_fft, hop = 256, 64
    f_bins = n_fft // 2 + 1
    x = rng.standard_normal(3000).astype(np.float32) * 0.1
    X = aug_stft(x, n_fft, hop, flag_unwrap_phase=unwrap)
    assert X.shape[0] == 2 * f_bins
    xr = iaug_stft(X, f_bins, nsrc=1, flag_unwrap_phase=unwrap, hop=hop)
    assert xr.shape[0] == 1 and xr.shape[2] == 1
    y = xr[0, : len(x), 0]
    nmse = np.mean((y - x) ** 2) / np.mean(x**2)
    assert nmse < (1e-4 if unwrap else 1e-6)


def test_reference_enhance_path_matches_make_enhancer(rng):
    """The whole offline path -- STFT, recurrence, ratio mask, iSTFT --
    against the float64 reference (dense U and S, per-frame FFTs and
    overlap-add) at a small width."""
    import jax.numpy as jnp
    from drnmf_tpu.enhance import make_enhancer
    from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
    from drnmf_tpu.reference import numpy_enhance

    n_fft, hop, r = 64, 16, 4
    f = n_fft // 2 + 1
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    config = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=3,
                         alph=10.0, lam1=0.5)
    params = init_drnmf_params(config, w)
    x = (0.3 * rng.standard_normal((2, 1500))).astype(np.float32)
    _, y_ref = numpy_enhance(params, config, x, n_fft, hop)
    out = np.asarray(make_enhancer(config, n_fft, hop)(
        params, pad_signal(jnp.asarray(x), n_fft, hop)))
    np.testing.assert_allclose(out[:, n_fft : n_fft + 1500], y_ref,
                               rtol=0, atol=1e-5)


def test_stft_istft_single_block_signal(rng):
    """Signals shorter than one hop still round-trip (one hop-block pad)."""
    n_fft, hop = 256, 64
    x = rng.standard_normal(40).astype(np.float32) * 0.3
    spec = stft(x, n_fft, hop)
    assert spec.shape[0] == n_frames_for_length(40, n_fft, hop)
    y = np.asarray(istft(spec, n_fft, hop, nsampl=40))
    nmse = np.mean((y - x) ** 2) / np.mean(x**2)
    assert nmse < 1e-6

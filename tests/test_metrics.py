"""Metrics engine tests.

SDR is validated against a float64 numpy transcription of the BSS Eval 3.0
projection (the golden oracle), plus analytic cases.  SNR/SegSNR/STOI/PESQ
are validated on analytic and monotonicity properties.
"""

import numpy as np
import pytest

from drnmf_tpu.metrics import bss_eval_sdr, snr, snrseg, stoi, pesq_16k


def ref_sdr_f64(se, s, flen=512):
    """float64 numpy transcription of bss_eval_sources' single-source
    projection (the decomposition behind score_audio.m:206)."""
    import scipy.linalg

    n = len(se)
    nfft = 1 << (n + flen - 1).bit_length()
    sf = np.fft.rfft(s, nfft)
    sef = np.fft.rfft(se, nfft)
    r = np.fft.irfft(sf * np.conj(sf), nfft)[:flen]
    c = np.fft.irfft(sef * np.conj(sf), nfft)[:flen]
    R = scipy.linalg.toeplitz(r)
    h = np.linalg.solve(R + 1e-12 * r[0] * np.eye(flen), c)
    s_target = np.fft.irfft(np.fft.rfft(h, nfft) * sf, nfft)[: n + flen - 1]
    e = np.concatenate([se, np.zeros(flen - 1)]) - s_target
    return 10 * np.log10(np.sum(s_target**2) / np.sum(e**2))


def _speechlike(rng, n=16000):
    t = np.arange(n) / 16000
    x = np.zeros(n)
    for f0, a in [(180, 1.0), (360, 0.6), (540, 0.4), (1200, 0.2)]:
        x += a * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t))
    return (x * env * 0.1).astype(np.float32)


def test_sdr_matches_f64_oracle(rng):
    s = _speechlike(rng)
    noise = 0.05 * rng.standard_normal(len(s)).astype(np.float32)
    se = s + noise
    ours = bss_eval_sdr(se, s)
    golden = ref_sdr_f64(se.astype(np.float64), s.astype(np.float64))
    assert abs(ours - golden) < 0.05, (ours, golden)


def test_sdr_perfect_reconstruction_is_high(rng):
    s = _speechlike(rng)
    assert bss_eval_sdr(s, s) > 40.0


def test_sdr_scaling_invariant_through_projection(rng):
    """A pure gain is absorbed by the projection filter -> very high SDR."""
    s = _speechlike(rng)
    assert bss_eval_sdr(0.5 * s, s) > 40.0


def test_sdr_filtered_estimate_absorbed(rng):
    """A short FIR distortion (< 512 taps) lies in the projection subspace."""
    s = _speechlike(rng)
    taps = np.array([0.8, 0.1, -0.05, 0.02], np.float32)
    se = np.convolve(s, taps, mode="full")[: len(s)].astype(np.float32)
    assert bss_eval_sdr(se, s) > 35.0


def test_sdr_monotone_in_noise(rng):
    s = _speechlike(rng)
    noise = rng.standard_normal(len(s)).astype(np.float32)
    sdrs = [bss_eval_sdr(s + g * noise, s) for g in (0.01, 0.03, 0.1)]
    assert sdrs[0] > sdrs[1] > sdrs[2]


def test_snr_analytic():
    ref = np.ones(1000, np.float32)
    est = ref + 0.1
    # SNR = 10log10(1000 / (1000*0.01)) = 20 dB
    assert abs(snr(est, ref) - 20.0) < 1e-3


def test_snrseg_range_and_monotone(rng):
    s = _speechlike(rng)
    n1 = s + 0.01 * rng.standard_normal(len(s)).astype(np.float32)
    n2 = s + 0.2 * rng.standard_normal(len(s)).astype(np.float32)
    l1, g1 = snrseg(n1, s)
    l2, g2 = snrseg(n2, s)
    assert l1 > l2 and g1 > g2
    assert -10.0 <= l1 <= 35.0 and -10.0 <= l2 <= 35.0


def test_stoi_identity_and_monotone(rng):
    s = _speechlike(rng, n=32000)
    noise = rng.standard_normal(len(s)).astype(np.float32)
    clean_score = stoi(s, s)
    assert clean_score > 0.99
    s1 = stoi(s, s + 0.05 * noise)
    s2 = stoi(s, s + 0.5 * noise)
    assert clean_score >= s1 > s2


def test_fused_device_metrics_match_individual(rng):
    """The single-dispatch SDR+SNR+SegSNR program == the individual
    kernels (the scoring engine's per-file dispatch-latency optimization)."""
    from drnmf_tpu.metrics.fused import fused_device_metrics

    s = _speechlike(rng, n=23000)
    noise = 0.1 * rng.standard_normal(len(s)).astype(np.float32)
    est = s + noise
    sdr_f, snr_f, loc_f, glo_f = fused_device_metrics(est, s, 16000)
    assert abs(sdr_f - bss_eval_sdr(est, s)) < 1e-3
    assert abs(snr_f - snr(est, s)) < 1e-3
    loc, glo = snrseg(est, s, 16000)
    assert abs(loc_f - loc) < 1e-3
    assert abs(glo_f - glo) < 1e-3


def test_pesq_identity_and_monotone(rng):
    s = _speechlike(rng, n=32000)
    noise = rng.standard_normal(len(s)).astype(np.float32)
    clean = pesq_16k(s, s)
    assert clean > 4.3
    p1 = pesq_16k(s, s + 0.02 * noise)
    p2 = pesq_16k(s, s + 0.3 * noise)
    assert clean >= p1 > p2
    assert pesq_16k(s, s, compute=False) == -1.0


def test_score_taskfiles_and_cache(tmp_path, rng):
    from drnmf_tpu.metrics import score_taskfiles, SCORE_LABELS
    from drnmf_tpu.dsp import wavwrite

    s = _speechlike(rng)
    pairs = []
    for i in range(3):
        ref_p = str(tmp_path / f"ref{i}.wav")
        est_p = str(tmp_path / f"est{i}.wav")
        noise = 0.05 * rng.standard_normal(len(s)).astype(np.float32)
        wavwrite(ref_p, 16000, s[None])
        wavwrite(est_p, 16000, (s + noise)[None])
        pairs.append((est_p, ref_p))

    save = str(tmp_path / "scores.npz")
    S, labels = score_taskfiles([p[0] for p in pairs], [p[1] for p in pairs],
                                savefile=save)
    assert S.shape == (3, 6)
    assert labels == SCORE_LABELS
    assert np.all(np.isfinite(S[:, [0, 1, 2, 3, 5]]))
    # cache hit returns identical scores
    S2, _ = score_taskfiles([p[0] for p in pairs], [p[1] for p in pairs],
                            savefile=save)
    np.testing.assert_array_equal(S, S2)
    # the cache records its align mode: requesting a different mode must
    # rescore (not silently return stale scores), and the rescoring run
    # rewrites the cache under the new mode
    S3, _ = score_taskfiles([p[0] for p in pairs], [p[1] for p in pairs],
                            savefile=save, align="full")
    assert str(np.load(save)["align"]) == "full"
    np.testing.assert_allclose(S, S3, atol=1e-4)  # pairs are aligned
    # legacy cache files (no align field) behave like align='guard'
    data = dict(np.load(save))
    data.pop("align")
    np.savez(save, **data)
    S4, _ = score_taskfiles([p[0] for p in pairs], [p[1] for p in pairs],
                            savefile=save, align="guard")
    np.testing.assert_array_equal(S3, S4)  # cache hit, no rescore


def test_score_taskfiles_native_matches_scipy_path(tmp_path, rng):
    """The native-batch-decode scoring path produces the same scores as the
    per-file scipy path."""
    import numpy as np
    from drnmf_tpu.dsp import wavwrite
    from drnmf_tpu.metrics import scoring
    from drnmf_tpu.data.native_loader import native_available

    if not native_available():
        import pytest
        pytest.skip("native loader unavailable")

    enh, ref = [], []
    for i in range(3):
        x = (rng.standard_normal(6000) * 0.1).astype(np.float32)
        y = x + (rng.standard_normal(6000) * 0.02).astype(np.float32)
        rp, ep = str(tmp_path / f"r{i}.wav"), str(tmp_path / f"e{i}.wav")
        wavwrite(rp, 16000, x[None])
        wavwrite(ep, 16000, y[None])
        ref.append(rp)
        enh.append(ep)

    S_native, _ = scoring.score_taskfiles(enh, ref)
    # force the scipy path
    import unittest.mock as mock
    with mock.patch("drnmf_tpu.data.native_loader.native_available",
                    return_value=False):
        S_scipy, _ = scoring.score_taskfiles(enh, ref)
    np.testing.assert_allclose(S_native, S_scipy, rtol=1e-5, atol=1e-5)


def test_metric_kernels_compile_count_bounded(rng):
    """Scoring a corpus of arbitrary lengths compiles O(log n) programs, not
    one per distinct length (pow2 bucketing in snrseg/stoi/bss_eval)."""
    from drnmf_tpu.metrics.snr import _snrseg_padded, snrseg
    from drnmf_tpu.metrics.stoi import _stoi_from_envelopes, stoi
    from drnmf_tpu.metrics.bss_eval import _sdr_padded, bss_eval_sdr

    lengths = [6001, 6007, 6103, 6500, 7001, 7333, 7901, 9000, 11111, 12345]
    for n in lengths:
        x = (rng.standard_normal(n) * 0.2).astype(np.float32)
        y = x + (rng.standard_normal(n) * 0.02).astype(np.float32)
        snrseg(y, x, 16000)
        stoi(x, y, 16000)
        bss_eval_sdr(y, x)
    # 10 distinct lengths spanning ~2x must not mean 10 compiles each
    assert _snrseg_padded._cache_size() <= 3
    assert _stoi_from_envelopes._cache_size() <= 4
    assert _sdr_padded._cache_size() <= 3


def test_bss_eval_sdr_many_matches_per_file(rng):
    ests, refs = [], []
    for n in (5000, 7000, 7100, 13000):
        x = (rng.standard_normal(n) * 0.2).astype(np.float32)
        refs.append(x)
        ests.append(x + (rng.standard_normal(n) * 0.05).astype(np.float32))
    from drnmf_tpu.metrics.bss_eval import bss_eval_sdr_many

    many = bss_eval_sdr_many(ests, refs)
    single = [bss_eval_sdr(e, r) for e, r in zip(ests, refs)]
    np.testing.assert_allclose(many, single, rtol=1e-5, atol=1e-4)


def test_snrseg_batch_matches_per_file(rng):
    from drnmf_tpu.metrics.snr import snrseg_batch

    lens = [5000, 7000, 8000]
    target = 16000
    e = np.zeros((3, target), np.float32)
    r = np.zeros((3, target), np.float32)
    for i, n in enumerate(lens):
        r[i, :n] = (rng.standard_normal(n) * 0.2).astype(np.float32)
        e[i, :n] = r[i, :n] + (rng.standard_normal(n) * 0.05).astype(np.float32)
    loc_b, glo_b = snrseg_batch(e, r, lens)
    for i, n in enumerate(lens):
        loc, glo = snrseg(e[i, :n], r[i, :n])
        assert abs(loc_b[i] - loc) < 1e-4
        assert abs(glo_b[i] - glo) < 1e-4


def test_pesq_snr_anchor_curve(rng):
    """PESQ model vs published speech+white-noise MOS-vs-SNR anchors
    (P.862-structured model; tolerance 0.15 MOS)."""
    fs = 16000
    r = np.random.default_rng(3)
    t = np.arange(fs * 4) / fs
    f0 = 140 * (1 + 0.1 * np.sin(2 * np.pi * 2.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(a * np.sin(k * phase)
            for k, a in [(1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25)])
    env = np.clip(np.sin(2 * np.pi * 1.7 * t), 0, None)
    x = (x * env * 0.1).astype(np.float32)

    anchors = {0: 1.2, 10: 1.8, 20: 2.6, 30: 3.5}
    prev = 0.0
    for snr_db, target in sorted(anchors.items()):
        noise = r.standard_normal(len(x)).astype(np.float32)
        noise *= np.sqrt(np.mean(x**2) / np.mean(noise**2) / 10**(snr_db / 10))
        mos = pesq_16k(x, x + noise)
        assert abs(mos - target) < 0.15, (snr_db, mos, target)
        assert mos > prev  # monotone in SNR
        prev = mos
    assert pesq_16k(x, x) > 4.3  # clean ~= 4.4-4.5


def test_fused_metrics_packed_matches_per_file(rng):
    """Packed-transfer batched device metrics == per-file fused metrics,
    including files whose near-periodic references need the escalating
    Toeplitz ridge (the packed path escalates at bucket granularity) and
    lengths spanning multiple pow2 FFT buckets."""
    import numpy as np
    from drnmf_tpu.metrics.fused import (
        fused_device_metrics, fused_metrics_packed)

    fs = 16000
    pairs = []
    for i in range(7):
        n = int(fs * (0.3 + 0.35 * i))  # spans several pow2 buckets
        t = np.arange(n) / fs
        if i % 2 == 0:
            # pure-ish sine: rank-deficient reference -> ridge escalation
            ref = (0.1 * np.sin(2 * np.pi * (100 + 20 * i) * t)).astype(
                np.float32)
        else:
            ref = (0.05 * rng.standard_normal(n)).astype(np.float32)
        est = ref + 0.01 * rng.standard_normal(n).astype(np.float32)
        pairs.append((est, ref))

    per_file = np.array([fused_device_metrics(e, r, fs) for e, r in pairs])
    packed = fused_metrics_packed([p[0] for p in pairs],
                                  [p[1] for p in pairs], fs)
    assert np.all(np.isfinite(packed))
    np.testing.assert_allclose(packed, per_file, rtol=1e-4, atol=1e-3)


def test_fused_packed_degenerate_reference_matches_per_file():
    """References that stay rank-deficient at the largest ridge take the
    same exact per-file SDR fallback in the packed path as in
    fused_device_metrics (ADVICE r2: no NaN divergence between paths)."""
    from drnmf_tpu.metrics.fused import fused_device_metrics, fused_metrics_packed

    rng = np.random.default_rng(5)
    fs = 16000
    t = np.arange(4000)
    # a pure sinusoid reference is near-rank-deficient for the 512-tap
    # Toeplitz solve; include healthy signals around it
    sine = np.sin(2 * np.pi * 440.0 * t / fs).astype(np.float32)
    refs = [rng.standard_normal(3000).astype(np.float32), sine,
            rng.standard_normal(5000).astype(np.float32)]
    ests = [r + 0.1 * rng.standard_normal(len(r)).astype(np.float32)
            for r in refs]

    packed = fused_metrics_packed(ests, refs, fs)
    for i in range(len(refs)):
        per_file = fused_device_metrics(ests[i], refs[i], fs)
        np.testing.assert_allclose(packed[i], np.asarray(per_file),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"file {i}")


# ---------------------------------------------------------------------------
# round-3 on-device engine (engine.py, pesq_device.py, stoi_device.py)
# ---------------------------------------------------------------------------

def _engine_battery(rng):
    """Mixed-length speech-like pairs for engine parity tests."""
    pairs = []
    for n, amp in [(9000, 0.05), (16000, 0.1), (23000, 0.2), (12000, 0.02)]:
        ref = _speechlike(rng, n)
        est = ref + amp * rng.standard_normal(n).astype(np.float32)
        pairs.append((est, ref))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_device_resample_matches_scipy(rng):
    """The on-device polyphase 16k->10k resampler is scipy's
    resample_poly to float32 roundoff."""
    import scipy.signal
    import jax.numpy as jnp
    from drnmf_tpu.metrics.stoi_device import resample_rows_16k_to_10k

    lens = [1000, 4321, 8000]
    L = 8192
    rows = np.zeros((len(lens), L), np.float32)
    sigs = []
    for i, n in enumerate(lens):
        x = rng.standard_normal(n).astype(np.float32)
        sigs.append(x)
        rows[i, :n] = x
    res, n10 = resample_rows_16k_to_10k(
        jnp.asarray(rows), jnp.asarray(lens, np.int32))
    res = np.asarray(res)
    for i, x in enumerate(sigs):
        want = scipy.signal.resample_poly(np.float64(x), 5, 8)
        m = int(np.asarray(n10)[i])
        assert m == len(want)
        np.testing.assert_allclose(res[i, :m], want, atol=2e-6)


def test_device_pesq_matches_host(rng):
    from drnmf_tpu.metrics._pesq_model import pesq_mos_aligned
    from drnmf_tpu.metrics.pesq_device import pesq_packed

    ests, refs = _engine_battery(rng)
    dev = pesq_packed(refs, ests, 16000)
    for i in range(len(ests)):
        host = pesq_mos_aligned(np.float64(refs[i]), np.float64(ests[i]))
        np.testing.assert_allclose(dev[i], host, atol=2e-3,
                                   err_msg=f"pair {i}")
    # degenerate (too short) input scores NaN on both paths
    short = rng.standard_normal(600).astype(np.float32)
    dev_short = pesq_packed([short], [short], 16000)
    assert np.isnan(dev_short[0])
    assert np.isnan(pesq_mos_aligned(np.float64(short), np.float64(short)))


def test_device_stoi_matches_host(rng):
    from drnmf_tpu.metrics.stoi_device import stoi_packed_device

    ests, refs = _engine_battery(rng)
    dev = stoi_packed_device(refs, ests, 16000)
    for i in range(len(ests)):
        host = stoi(refs[i], ests[i], 16000)
        np.testing.assert_allclose(dev[i], host, atol=1e-3,
                                   err_msg=f"pair {i}")


def test_engine_matches_per_file_paths(rng):
    """score_all_packed (one shared transfer, all metrics on device)
    agrees with the per-file host/fused paths on every column."""
    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.scoring import _score_pair

    ests, refs = _engine_battery(rng)
    S, delays = score_all_packed(ests, refs, 16000)
    assert np.all(delays == 0)
    for i in range(len(ests)):
        want = _score_pair(ests[i], refs[i], 16000)
        np.testing.assert_allclose(S[i], want, rtol=5e-4, atol=2e-3,
                                   err_msg=f"pair {i}")


def test_engine_ridge_escalation_matches_per_file(rng):
    """score_all_packed's retry rounds (which re-dispatch ONLY the fused
    family and merge the first pass's PESQ/STOI/delay columns) agree with
    the per-file path for references that need ridge escalation -- a pure
    sine (near-rank-deficient for the 512-tap Toeplitz solve, exercising
    the exact per-file SDR fallback) mixed with healthy signals."""
    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.scoring import _score_pair

    fs = 16000
    t = np.arange(11000)
    sine = (0.1 * np.sin(2 * np.pi * 440.0 * t / fs)).astype(np.float32)
    refs = [_speechlike(rng, 9000), sine, _speechlike(rng, 15000)]
    ests = [r + 0.05 * rng.standard_normal(len(r)).astype(np.float32)
            for r in refs]
    S, delays = score_all_packed(ests, refs, fs)
    assert np.all(np.isfinite(S))
    for i in range(len(refs)):
        want = _score_pair(ests[i], refs[i], fs)
        np.testing.assert_allclose(S[i], want, rtol=5e-4, atol=2e-3,
                                   err_msg=f"pair {i}")


def test_engine_spurious_delay_guard(rng):
    """A delay estimate that leaves fewer than max(FLEN, frame) samples of
    overlap (short file + large correlation peak) is treated as spurious:
    the unshifted first-pass scores are kept and no NaN row is written
    (review r3: |d| ~ n made the compensation slice near-empty)."""
    from drnmf_tpu.metrics.engine import score_all_packed

    n, shift = 1000, 600  # overlap 400 < FLEN=512 -> guard trips
    # white noise: the cross-correlation peak at the true lag is unambiguous
    # (a periodic carrier would alias to a pitch-period lag instead)
    ref = rng.standard_normal(n).astype(np.float32)
    est = np.concatenate([np.zeros(shift, np.float32), ref[: n - shift]])
    S, delays = score_all_packed([est], [ref], 16000)
    assert delays[0] == 0  # reset by the guard
    # the kept scores are the unshifted per-file scores (PESQ/STOI are NaN
    # for a file shorter than STOI's analysis window on BOTH paths)
    from drnmf_tpu.metrics.scoring import _score_pair
    want = _score_pair(est, ref, 16000)
    assert np.all(np.isfinite(S[0][:4])), S
    np.testing.assert_allclose(S[0], want, rtol=5e-4, atol=2e-3)


def test_engine_alignment_guard(rng):
    """A deliberately shifted estimate is detected (nonzero delay) and
    re-scored after compensation, landing near the aligned scores
    (misalignment must not silently tank metrics)."""
    from drnmf_tpu.metrics.engine import score_all_packed

    ref = _speechlike(rng, 20000)
    est = ref + 0.05 * rng.standard_normal(len(ref)).astype(np.float32)
    shift = 160  # 10 ms
    est_shifted = np.concatenate(
        [np.zeros(shift, np.float32), est[:-shift]])

    S_aligned, d0 = score_all_packed([est], [ref], 16000)
    S_shift, d1 = score_all_packed([est_shifted], [ref], 16000)
    assert d0[0] == 0
    assert d1[0] == shift
    # compensated scores are close to the aligned ones (the shifted pair
    # loses `shift` samples at the edges)
    np.testing.assert_allclose(S_shift[0], S_aligned[0], rtol=0.05,
                               atol=0.25)
    # without the guard a LARGE shift collapses the shift-sensitive
    # metrics (SDR alone absorbs shifts < 512 samples via its projection
    # filter); with it, the compensated scores stay near the aligned ones
    big = 1000  # 62 ms
    est_big = np.concatenate([np.zeros(big, np.float32), est[:-big]])
    S_big, d2 = score_all_packed([est_big], [ref], 16000)
    assert d2[0] == big
    naive_segsnr = snrseg(est_big, ref, 16000)[0]
    assert S_big[0][2] > naive_segsnr + 2.0
    np.testing.assert_allclose(S_big[0][2], S_aligned[0][2], atol=1.0)


def _anchor_speech(fs=16000, seconds=4.0):
    """The anchor test's speech-like carrier (harmonic + voiced envelope)."""
    t = np.arange(int(fs * seconds)) / fs
    f0 = 140 * (1 + 0.1 * np.sin(2 * np.pi * 2.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(a * np.sin(k * phase)
            for k, a in [(1, 1.0), (2, 0.6), (3, 0.4), (4, 0.25)])
    env = np.clip(np.sin(2 * np.pi * 1.7 * t), 0, None)
    return (x * env * 0.1).astype(np.float32)


def _stft_simple(x, n=512, hop=256):
    w = np.hanning(n)
    m = (len(x) - n) // hop + 1
    idx = np.arange(m)[:, None] * hop + np.arange(n)[None, :]
    return np.fft.rfft(x[idx] * w, axis=-1), m


def _istft_simple(spec, n=512, hop=256, length=None):
    w = np.hanning(n)
    m = spec.shape[0]
    out = np.zeros(n + hop * (m - 1))
    frames = np.fft.irfft(spec, n=n, axis=-1) * w
    for i in range(m):
        out[i * hop : i * hop + n] += frames[i]
    # 50%-overlap Hann pairs sum to ~1 after the double window
    out /= (w**2).sum() / hop
    return out[:length] if length else out


def test_pesq_mask_distortion_anchor_family(rng):
    """Second PESQ anchor family: mask-style
    distortions -- additive musical noise (isolated random time-frequency
    atoms) and time-varying spectral deletion (randomly gated spectrogram
    bins) -- the distortion class produced by mask-based enhancement,
    distinct from additive white noise.  Asserts monotone degradation with
    distortion severity and cross-family consistency (a lightly-distorted
    signal from either family outranks a heavily-distorted one from the
    other), i.e. the three calibrated scalars transfer across distortion
    classes.  Observed (and standard-faithful) asymmetry: ADDED energy is
    penalized much harder than removed energy (P.862's asymmetry factor
    only fires on additions, and its frequency compensation absorbs the
    constant part of an attenuation as linear filtering)."""
    fs = 16000
    r = np.random.default_rng(11)
    # wideband carrier (harmonics to ~3.4 kHz) -- spectral gating needs
    # energy in the gated bands to be audible
    t = np.arange(fs * 4) / fs
    f0 = 140 * (1 + 0.1 * np.sin(2 * np.pi * 2.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum((1.0 / k) * np.sin(k * phase) for k in range(1, 25))
    env = np.clip(np.sin(2 * np.pi * 1.7 * t), 0, None)
    x = (x * env * 0.1).astype(np.float32)

    # --- family A: musical noise.  Add isolated random time-frequency
    # atoms (the classic spectral-subtraction residue) at increasing
    # density/level.  The reference is the clean signal passed through the
    # same STFT round trip, so only the atoms differ.
    spec, m = _stft_simple(x)
    x_rt = _istft_simple(spec, length=len(x)).astype(np.float32)
    peak = np.abs(spec).max()
    mos_musical = []
    for density, level in [(0.002, 0.05), (0.01, 0.1), (0.04, 0.2),
                           (0.1, 0.4)]:
        sp = spec.copy()
        gate = r.uniform(size=sp.shape) < density
        sp = sp + gate * level * peak * np.exp(
            2j * np.pi * r.uniform(size=sp.shape))
        y = _istft_simple(sp, length=len(x)).astype(np.float32)
        mos_musical.append(pesq_16k(x_rt, y))
    assert all(np.isfinite(mos_musical))
    # monotone decreasing with severity
    for a, b in zip(mos_musical, mos_musical[1:]):
        assert b < a + 0.05, mos_musical
    assert mos_musical[0] > 3.8  # barely-audible atoms stay high-MOS
    assert mos_musical[-1] < mos_musical[0] - 0.8  # heavy atoms collapse

    # --- family B: time-varying spectral deletion (randomly gated 16-bin
    # blocks of increasing probability/depth -- over-aggressive masking).
    F = spec.shape[1]
    nb = F // 16 + 1
    mos_gate = []
    for p_gate, depth in [(0.1, 0.5), (0.3, 0.8), (0.5, 1.0), (0.8, 1.0)]:
        gate = r.uniform(size=(m, nb)) < p_gate
        gate_bins = np.repeat(gate, 16, axis=1)[:, :F]
        y = _istft_simple(spec * (1.0 - depth * gate_bins),
                          length=len(x)).astype(np.float32)
        mos_gate.append(pesq_16k(x_rt, y))
    assert all(np.isfinite(mos_gate))
    for a, b in zip(mos_gate, mos_gate[1:]):
        assert b < a + 0.05, mos_gate
    assert mos_gate[0] > 4.2
    assert mos_gate[-1] < mos_gate[0] - 0.5

    # --- cross-family consistency: light distortion of either family
    # outranks heavy distortion of the other
    assert mos_musical[0] > mos_gate[-1] + 0.3
    assert mos_gate[0] > mos_musical[-1] + 0.3


def test_engine_int16_path_matches_float(rng):
    """Raw-PCM16 packing + on-device dequantization produces identical
    scores to the float32 path (the transfer-halving optimization must be
    value-exact)."""
    from drnmf_tpu.metrics.engine import score_all_packed

    ests_f, refs_f, ests_i, refs_i = [], [], [], []
    for n in (9000, 14000):
        ref = _speechlike(rng, n)
        est = ref + 0.05 * rng.standard_normal(n).astype(np.float32)
        ri = np.clip(np.round(ref * 32768), -32768, 32767).astype(np.int16)
        ei = np.clip(np.round(est * 32768), -32768, 32767).astype(np.int16)
        refs_i.append(ri); ests_i.append(ei)
        refs_f.append(ri.astype(np.float32) / 32768.0)
        ests_f.append(ei.astype(np.float32) / 32768.0)
    S_f, d_f = score_all_packed(ests_f, refs_f, 16000)
    S_i, d_i = score_all_packed(ests_i, refs_i, 16000)
    np.testing.assert_array_equal(d_f, d_i)
    np.testing.assert_allclose(S_i, S_f, rtol=1e-5, atol=1e-5)


def test_engine_mixed_dtype_lists_match_float(rng):
    """A list mixing raw-PCM16 and float32 entries must score each file
    correctly (int16 entries dequantized host-side when the bucket packs
    float32) -- not silently truncate/mis-scale the minority dtype."""
    from drnmf_tpu.metrics.engine import score_all_packed

    ests_f, refs_f, ests_m, refs_m = [], [], [], []
    for j, n in enumerate((9000, 14000)):
        ref = _speechlike(rng, n)
        est = ref + 0.05 * rng.standard_normal(n).astype(np.float32)
        ri = np.clip(np.round(ref * 32768), -32768, 32767).astype(np.int16)
        ei = np.clip(np.round(est * 32768), -32768, 32767).astype(np.int16)
        rf = ri.astype(np.float32) / 32768.0
        ef = ei.astype(np.float32) / 32768.0
        refs_f.append(rf); ests_f.append(ef)
        # alternate dtypes across entries (and across est/ref within a pair)
        refs_m.append(ri if j % 2 == 0 else rf)
        ests_m.append(ef if j % 2 == 0 else ei)
    S_f, d_f = score_all_packed(ests_f, refs_f, 16000)
    S_m, d_m = score_all_packed(ests_m, refs_m, 16000)
    np.testing.assert_array_equal(d_f, d_m)
    np.testing.assert_allclose(S_m, S_f, rtol=1e-5, atol=1e-5)


def test_read_batch_i16_matches_float(tmp_path, rng):
    from drnmf_tpu.data.native_loader import (
        native_available, read_batch, read_batch_i16)
    from drnmf_tpu.dsp.wav import wavwrite

    if not native_available():
        pytest.skip("native loader unavailable")
    paths = []
    for i in range(3):
        p = str(tmp_path / f"t{i}.wav")
        wavwrite(p, 16000,
                 rng.uniform(-0.5, 0.5, (1, 900 + 111 * i)).astype(np.float32))
        paths.append(p)
    f32, l1 = read_batch(paths)
    out = read_batch_i16(paths)
    assert out is not None
    i16, l2 = out
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(f32, i16.astype(np.float32) / 32768.0)


def test_engine_short_file_bucket(rng):
    """Files short enough that their pow2 bucket can't hold the full
    +-MAX_LAG delay search (nfft < 2*MAX_LAG+1) score without error: the
    lag range clamps to the bucket size instead of slicing a mismatched
    correlation window (review r3: a single 32 ms wav aborted the whole
    scoring pass)."""
    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.scoring import _score_pair

    ests, refs = [], []
    for n in (400, 700, 9000):  # 400+FLEN -> nfft 1024 << 2*2047+1
        ref = _speechlike(rng, n)
        est = ref + 0.05 * rng.standard_normal(n).astype(np.float32)
        refs.append(ref)
        ests.append(est)
    S, delays = score_all_packed(ests, refs, 16000)
    assert np.all(delays == 0)
    for i in range(len(ests)):
        want = _score_pair(ests[i], refs[i], 16000)
        np.testing.assert_allclose(S[i], want, rtol=5e-4, atol=2e-3,
                                   err_msg=f"pair {i}")


# ---------------------------------------------------------------------------
# round-4 P.862-style time alignment (align.py + engine align="full")
# ---------------------------------------------------------------------------

def _gappy_speech(rng, n_utts=2, utt=16000, gap=8000):
    """Speech-like bursts separated by silence -- utterance structure for
    the P.862-style alignment tests."""
    parts = [np.zeros(gap, np.float32)]
    for _ in range(n_utts):
        parts.append(_speechlike(rng, utt))
        parts.append(np.zeros(gap, np.float32))
    return np.concatenate(parts)


def _shift(x, d):
    """x delayed by d samples (d<0: advanced), same length."""
    if d >= 0:
        return np.concatenate([np.zeros(d, np.float32), x[: len(x) - d]])
    return np.concatenate([x[-d:], np.zeros(-d, np.float32)])


def test_align_estimate_delay_unbounded(rng):
    """Constant delays well beyond the engine's +-2047 guard range are
    recovered exactly by the coarse-envelope + fine estimator."""
    from drnmf_tpu.metrics.align import estimate_delay

    ref = _gappy_speech(rng)
    est = ref + 0.02 * rng.standard_normal(len(ref)).astype(np.float32)
    for d in (0, 160, -300, 5000, -4096, 12000):
        got = estimate_delay(_shift(est, d), ref, 16000)
        assert got.d == d, (d, got)
        assert got.peak > 0.5


def test_align_pair_piecewise(rng):
    """Per-utterance delays are recovered and compensate_piecewise leaves
    zero residual delay."""
    from drnmf_tpu.metrics.align import (align_pair, compensate_piecewise,
                                         estimate_delay, split_utterances)

    ref = _gappy_speech(rng, n_utts=2)
    est = ref + 0.02 * rng.standard_normal(len(ref)).astype(np.float32)
    utts_true = split_utterances(ref, 16000)
    assert len(utts_true) == 2
    # shift each utterance by a different amount (seams in the gaps)
    es = np.zeros_like(est)
    true_d = [100, 400]
    for (s0, s1), d in zip(utts_true, true_d):
        lo, hi = s0 + d, min(len(es), s1 + d)
        es[lo:hi] = est[s0 : s0 + (hi - lo)]
    utts, delays, g = align_pair(es, ref, 16000)
    assert delays == true_d
    ea, ra = compensate_piecewise(es, ref, utts, delays)
    assert estimate_delay(ea, ra, 16000).d == 0


def _noisy_active(rng, ref, amp=0.05):
    """ref + noise restricted to active samples, so shift-compensation
    trims (which drop silent edges) don't change what is scored."""
    mask = (np.abs(ref) > 0).astype(np.float32)
    return ref + amp * mask * rng.standard_normal(len(ref)).astype(
        np.float32)


def test_engine_full_alignment_large_constant_shift(rng):
    """align='full' recovers a shift far beyond MAX_LAG (where the guard
    tier cannot) and the compensated scores land on the aligned ones.
    The exact-span check: the compensated pair IS (est[:n-d], ref[:n-d]),
    so its scores must match that slice's to engine precision."""
    from drnmf_tpu.metrics.engine import MAX_LAG, score_all_packed

    ref = _gappy_speech(rng)
    est = _noisy_active(rng, ref)
    n = len(ref)
    d = 2 * MAX_LAG + 906  # 5000 samples, 312 ms
    S0, _ = score_all_packed([est], [ref], 16000, align="off")
    S_span, _ = score_all_packed([est[: n - d]], [ref[: n - d]], 16000,
                                 align="off")
    S, delays = score_all_packed([_shift(est, d)], [ref], 16000,
                                 align="full")
    assert delays[0] == d
    np.testing.assert_allclose(S[0], S_span[0], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(S[0], S0[0], rtol=0.05, atol=0.25)


def test_engine_full_alignment_piecewise(rng):
    """align='full' on a pair whose two utterances carry different delays:
    per-utterance compensation lands the scores near the aligned ones
    (the guard tier would compensate at best one of the delays)."""
    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.align import split_utterances

    ref = _gappy_speech(rng, n_utts=2)
    est = _noisy_active(rng, ref)
    utts = split_utterances(ref, 16000)
    es = np.zeros_like(est)
    for (s0, s1), d in zip(utts, [700, 3200]):
        lo, hi = s0 + d, min(len(es), s1 + d)
        es[lo:hi] = est[s0 : s0 + (hi - lo)]
    S0, _ = score_all_packed([est], [ref], 16000, align="off")
    S, _ = score_all_packed([es], [ref], 16000, align="full")
    np.testing.assert_allclose(S[0], S0[0], rtol=0.05, atol=0.25)


def test_engine_constant_compensation_stays_on_device(rng, monkeypatch):
    """A fully-shifted corpus is compensated WITHOUT repacking: the
    constant-delay re-pass reuses the resident device buffers with
    adjusted unpack offsets, not through a per-file host path.  pack_pair
    must run
    exactly once per bucket."""
    import drnmf_tpu.metrics.engine as eng

    calls = {"n": 0}
    real_pack = eng.pack_pair

    def counting_pack(*a, **kw):
        calls["n"] += 1
        return real_pack(*a, **kw)

    monkeypatch.setattr(eng, "pack_pair", counting_pack)

    ests, refs = [], []
    for k in range(6):
        # white-noise signals: the bounded device cross-correlation is
        # unambiguous (a periodic carrier aliases to a pitch-period lag)
        n = 12000 + 1000 * k
        ref = (0.1 * rng.standard_normal(n)).astype(np.float32)
        est = ref + 0.02 * rng.standard_normal(n).astype(np.float32)
        refs.append(ref)
        ests.append(_shift(est, 800))
    n_buckets = len({1 << int(np.ceil(np.log2(len(r) + 512)))
                     for r in refs})
    S, delays = eng.score_all_packed(ests, refs, 16000, align="guard")
    assert calls["n"] == n_buckets  # no second packing for the re-pass
    assert np.all(delays == 800)
    assert np.all(np.isfinite(S[:, [0, 1, 2, 3, 5]]))


def test_scoring_align_full_passthrough(rng, tmp_path):
    """score_taskfiles(align='full') wires through to the engine: a wav
    pair shifted beyond the guard range scores like the aligned pair."""
    from drnmf_tpu.dsp.wav import wavwrite
    from drnmf_tpu.metrics.scoring import score_taskfiles

    ref = _gappy_speech(rng)
    est = _noisy_active(rng, ref)
    d = 4000
    paths = {}
    for name, sig in [("ref", ref), ("est", _shift(est, d)),
                      ("est0", est)]:
        p = str(tmp_path / f"{name}.wav")
        wavwrite(p, 16000, sig)
        paths[name] = p
    # two pairs so the packed engine path (len > 1) is taken
    S, _ = score_taskfiles([paths["est"], paths["est0"]],
                           [paths["ref"], paths["ref"]], align="full")
    np.testing.assert_allclose(S[0], S[1], rtol=0.05, atol=0.25)


def test_pesq_reverberation_anchor_family(rng):
    """Third PESQ anchor family: reverberation /
    time-smearing -- convolution with exponentially-decaying noise RIRs
    (direct path at t=0, so the pair stays sample-aligned) of increasing
    T60 and wet level.  This is the remaining distortion class mask-based
    systems meet (room capture before enhancement, or smeared musical
    residue after).  Asserts monotone MOS degradation with reverberation
    severity and cross-family rank consistency with the additive-noise and
    mask-distortion families, i.e. the three calibrated scalars transfer
    across all three distortion classes.  Cross-family worst-case
    calibration error stays the SNR family's 0.15 MOS (the only family
    with published absolute anchors); the other two families pin
    STRUCTURE (monotonicity + cross-family ranking), which is what the
    in-repo use -- ranking enhancement systems -- needs."""
    fs = 16000
    r = np.random.default_rng(23)
    x = _anchor_speech(fs)

    def reverb(sig, t60, wet):
        n_h = int(t60 * fs)
        decay = np.exp(-3.0 * np.log(10.0) * np.arange(n_h) / (t60 * fs))
        tail = r.standard_normal(n_h) * decay
        tail *= wet / np.sqrt(np.sum(tail**2))  # wet-to-direct ratio
        h = np.concatenate([[1.0], tail])
        y = np.convolve(np.float64(sig), h)[: len(sig)]
        return y.astype(np.float32)

    mos_reverb = []
    for t60, wet in [(0.1, 0.2), (0.3, 0.5), (0.6, 0.9), (1.2, 1.4)]:
        mos_reverb.append(pesq_16k(x, reverb(x, t60, wet)))
    assert all(np.isfinite(mos_reverb))
    for a, b in zip(mos_reverb, mos_reverb[1:]):
        assert b < a + 0.05, mos_reverb  # monotone in severity
    assert mos_reverb[0] > 3.6   # barely-audible early reflections
    assert mos_reverb[-1] < 2.8  # heavy smearing collapses
    assert mos_reverb[0] - mos_reverb[-1] > 1.0

    # cross-family rank consistency vs additive white noise: light reverb
    # outranks heavy noise and vice versa (the asymmetry/compensation
    # stages must not blow up on time-smeared energy)
    noise = r.standard_normal(len(x)).astype(np.float32)
    def at_snr(db):
        w = noise * np.sqrt(
            np.mean(x**2) / np.mean(noise**2) / 10 ** (db / 10))
        return pesq_16k(x, x + w)
    assert mos_reverb[0] > at_snr(5) + 0.3    # light reverb >> 5 dB noise
    assert at_snr(30) > mos_reverb[-1] + 0.3  # 30 dB noise >> heavy reverb


def test_align_degenerate_inputs(rng):
    """Silence, near-empty, and constant signals produce a zero-delay,
    zero-confidence estimate instead of crashing or a spurious peak."""
    from drnmf_tpu.metrics.align import (align_pair, estimate_delay,
                                         split_utterances)

    z = np.zeros(4000, np.float32)
    s = _speechlike(rng, 4000)
    assert estimate_delay(z, z, 16000) == (0, 0.0, 0.0)
    assert estimate_delay(z, s, 16000).d == 0
    assert estimate_delay(s[:50], s[:50], 16000) == (0, 0.0, 0.0)  # < 2 frames
    assert split_utterances(z, 16000) == [(0, len(z))]
    assert split_utterances(np.zeros(10, np.float32), 16000) == [(0, 10)]
    utts, delays, g = align_pair(z, z, 16000)
    assert delays == [0]


def test_engine_guard_refines_aliased_delay(rng):
    """Guard tier: the bounded device estimate of a shifted PERIODIC
    carrier aliases to a pitch-period lag (observed: 533 for a true 800
    -- 3 x the 180 Hz period); the unbounded host refinement recovers the
    true shift before compensation."""
    from drnmf_tpu.metrics.engine import score_all_packed

    ref = _gappy_speech(rng, n_utts=1, utt=20000)
    est = _noisy_active(rng, ref)
    d = 800
    S, delays = score_all_packed([_shift(est, d)], [ref], 16000,
                                 align="guard")
    assert delays[0] == d, delays
    S0, _ = score_all_packed([est], [ref], 16000, align="off")
    np.testing.assert_allclose(S[0], S0[0], rtol=0.05, atol=0.25)


def test_scoring_single_pair_alignment(rng, tmp_path):
    """align is honored on the per-file path too (reviewer finding: a
    single file pair bypassed the packed engine and scored the shifted
    pair as given despite align='full')."""
    from drnmf_tpu.dsp.wav import wavwrite
    from drnmf_tpu.metrics.scoring import score_taskfiles

    ref = _gappy_speech(rng)
    est = _noisy_active(rng, ref)
    d = 4000
    p_ref, p_est = str(tmp_path / "r.wav"), str(tmp_path / "e.wav")
    wavwrite(p_ref, 16000, ref)
    wavwrite(p_est, 16000, _shift(est, d))
    S1, _ = score_taskfiles([p_est], [p_ref], align="full")  # 1 pair
    S0, _ = score_taskfiles([p_est], [p_ref], align="off",
                            savefile=None)
    # compensated scores land near the aligned pair's; unaligned collapse
    from drnmf_tpu.metrics.scoring import _score_pair
    want = _score_pair(est[: len(est) - d], ref[: len(ref) - d], 16000)
    np.testing.assert_allclose(S1[0], want, rtol=0.05, atol=0.25)
    assert S1[0][2] > S0[0][2] + 0.5  # SegSNR gains from compensation


def test_sharded_engine_matches_single_device(rng):
    """score_all_sharded over the 8-device CPU mesh equals the
    single-device engine on every column -- the mesh analog of the
    reference's parfor file pool (score_audio.m:72-98): rows split over
    devices, no collectives.  The battery spans two pow2 buckets, one
    with more rows than devices and one with fewer (exercising dummy-row
    padding), plus a near-rank-deficient sine pair (exercising the
    sharded ridge-escalation retry rounds)."""
    from drnmf_tpu.metrics.engine import score_all_packed
    from drnmf_tpu.metrics.sharded import score_all_sharded
    from drnmf_tpu.parallel import make_mesh

    ests, refs = _engine_battery(rng)
    t = np.arange(11000)
    sine = (0.1 * np.sin(2 * np.pi * 440.0 * t / 16000)).astype(np.float32)
    refs.append(sine)
    ests.append(sine + 0.05 * rng.standard_normal(len(sine))
                .astype(np.float32))
    for i in range(6):
        r = _speechlike(rng, 7000 + 931 * i)
        refs.append(r)
        ests.append(r + 0.1 * rng.standard_normal(len(r))
                    .astype(np.float32))

    S1, d1 = score_all_packed(ests, refs, 16000)
    S2, d2 = score_all_sharded(ests, refs, make_mesh(8), fs=16000)
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_allclose(S2, S1, rtol=1e-5, atol=1e-5)


def test_pesq_mnru_clip_dropout_anchor_families(rng):
    """Fourth/fifth/sixth PESQ anchor families:
    MNRU-style multiplicative noise (P.862's own reference degradation,
    y = x(1 + 10^(-Q/20) n)), amplitude clipping (harmonic-distortion
    additions), and packet-loss dropouts (20 ms frame deletions).  Each
    asserts monotone MOS degradation with severity plus cross-family rank
    consistency with the additive-noise family.  Standard-faithful
    structure pinned here: (a) MNRU noise is modulated by the speech, so
    at matched nominal level it outranks constant additive noise;
    (b) deletions are penalized far less than additions (P.862's
    asymmetry factor fires only on added energy) -- deleting HALF the
    frames still outranks 10 dB additive noise by over 1 MOS.  Absolute
    calibration remains pinned by the SNR family (the only one with
    published offline anchors, <=0.15 MOS); these families pin structure,
    which is what ranking enhancement systems needs."""
    fs = 16000
    r = np.random.default_rng(31)
    x = _anchor_speech(fs)

    # --- family 4: MNRU multiplicative noise, monotone in Q
    mos_mnru = {}
    for q in [40, 30, 20, 10, 5]:
        n = r.standard_normal(len(x)).astype(np.float32)
        y = (x * (1.0 + 10 ** (-q / 20.0) * n)).astype(np.float32)
        mos_mnru[q] = pesq_16k(x, y)
    vals = [mos_mnru[q] for q in [40, 30, 20, 10, 5]]
    assert all(np.isfinite(vals))
    for a, b in zip(vals, vals[1:]):
        assert b < a + 0.05, mos_mnru
    assert mos_mnru[40] > 3.8    # near-transparent at Q=40
    assert mos_mnru[5] < 2.5     # heavy modulation collapses
    assert mos_mnru[40] - mos_mnru[5] > 1.5

    # --- family 5: amplitude clipping, monotone in severity
    peak = np.abs(x).max()
    mos_clip = []
    for c in [0.9, 0.6, 0.3, 0.1, 0.03]:
        y = np.clip(x, -c * peak, c * peak).astype(np.float32)
        mos_clip.append(pesq_16k(x, y))
    assert all(np.isfinite(mos_clip))
    for a, b in zip(mos_clip, mos_clip[1:]):
        assert b < a + 0.05, mos_clip
    assert mos_clip[0] > 3.8 and mos_clip[-1] < 2.6
    assert mos_clip[0] - mos_clip[-1] > 1.2

    # --- family 6: packet-loss dropouts (20 ms frames), monotone in rate
    flen = int(0.020 * fs)
    nfr = len(x) // flen
    mos_drop = []
    for rate in [0.01, 0.15, 0.5]:
        y = x[: nfr * flen].copy().reshape(nfr, flen)
        y[r.uniform(size=nfr) < rate] = 0.0
        mos_drop.append(pesq_16k(x[: nfr * flen], y.reshape(-1)))
    assert all(np.isfinite(mos_drop))
    for a, b in zip(mos_drop, mos_drop[1:]):
        assert b < a + 0.05, mos_drop
    assert mos_drop[0] > 3.9 and mos_drop[-1] < 3.5

    # --- cross-family ranking vs additive white noise
    n = r.standard_normal(len(x)).astype(np.float32)

    def at_snr(db):
        w = n * np.sqrt(np.mean(x**2) / np.mean(n**2) / 10 ** (db / 10))
        return pesq_16k(x, (x + w).astype(np.float32))

    # modulated (speech-gated) noise outranks constant noise at matched
    # nominal level; constant 30 dB noise outranks heavy MNRU
    assert mos_mnru[10] > at_snr(5) + 0.3
    assert at_snr(30) > mos_mnru[5] + 0.3
    # the P.862 asymmetry: 50% frame deletion >> 10 dB additive noise
    assert mos_drop[-1] > at_snr(10) + 1.0

"""Scoring engine: per-file metric computation over taskfile pairs.

Replaces the reference's MATLAB subprocess stack (score_audio.m:1-239 invoked
through audio_dataset.py:399-435): reads enhanced/reference wav pairs,
truncates to the common length, computes
[SDR, SNR, SegSNR local, SegSNR global, PESQ, STOI] per file, caches results
(.npz instead of .mat), and aggregates per SNR condition exactly like the
reference driver (enhance.py:1396-1433 sums raw scores over SNR buckets and
divides by the total file count).

Parallelism: where the reference used MATLAB ``parfor`` over files
(score_audio.m:72-98), here the engine is PACKED-BATCHED: the device-side
metrics (SDR/SNR/SegSNR) for each pow2-length bucket of files cross the
host<->device boundary as one exact-bytes packed transfer and run as one
batched program (``fused.fused_metrics_packed``), overlapped with a host
thread pool computing PESQ/STOI; at 16 kHz the all-device engine
(``engine.score_all_packed``) scores all six metrics per bucket.  Scores
are bit-identical to the per-file path.  Exact-bytes packing, device-side
unpacking and bucket-level ridge escalation are what make batching pay;
padded-batch transfers do not.  Per-file streaming remains for mixed-fs
lists and the no-native-loader path.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..dsp.wav import wavread_fs
from .stoi import stoi
from .pesq import pesq_16k

SCORE_LABELS = ["SDR", "SNR", "SegSNR local", "SegSNR global", "PESQ", "STOI"]


def _apply_alignment(xest, xref, fs, align):
    """Pre-align one pair for the per-file scoring paths (the packed
    engine compensates on device; these paths compensate on the host with
    the same estimators so align semantics do not depend on which path a
    corpus takes).  'guard': constant compensation when the unbounded
    host estimate is nonzero; 'full': P.862-style per-utterance
    alignment; 'off': as given.  Estimates that leave <512 overlapping
    samples are treated as spurious (engine.py's guard)."""
    if align == "off":
        return xest, xref
    from .align import align_pair, compensate_piecewise, estimate_delay

    n = min(len(xest), len(xref))
    xest, xref = xest[:n], xref[:n]
    if align == "guard":
        d = estimate_delay(xest, xref, fs).d
        if d == 0:
            return xest, xref
        utts, uds = [(0, n)], [d]
    else:
        utts, uds, _ = align_pair(xest, xref, fs)
        if all(d == 0 for d in uds):
            return xest, xref
    if max(abs(d) for d in uds) >= n - 512:
        return xest, xref  # spurious estimate; keep the unshifted pair
    print(f"  WARNING: compensating delay(s) {uds} before scoring")
    return compensate_piecewise(np.asarray(xest, np.float32),
                                np.asarray(xref, np.float32), utts, uds)


def _score_pair(xest, xref, fs, compute_pesq=True):
    """Scores for one time-aligned pair of signals
    (score_audio.m:177-238 semantics: truncate to common length first).

    SDR/SNR/SegSNR run as ONE device program (the engine is dispatch
    -latency-bound; see module docstring); PESQ/STOI are host-side."""
    from .fused import fused_device_metrics

    n = min(len(xest), len(xref))
    xest, xref = xest[:n], xref[:n]
    sdr, raw_snr, loc, glo = fused_device_metrics(xest, xref, fs)
    pesq_mos = pesq_16k(xref, xest, fs, compute=compute_pesq)
    stoi_score = stoi(xref, xest, fs)
    return np.array([sdr, raw_snr, loc, glo, pesq_mos, stoi_score])


def compute_scores(est_file, ref_file, compute_pesq=True, align="guard"):
    """Scores for one file pair."""
    xest, fs_est = wavread_fs(est_file)
    xref, fs_ref = wavread_fs(ref_file)
    if fs_est != fs_ref:
        raise ValueError(f"fs mismatch: {fs_est} vs {fs_ref}")
    xe, xr = _apply_alignment(xest[0], xref[0], fs_est, align)
    return _score_pair(xe, xr, fs_est, compute_pesq=compute_pesq)


def score_taskfiles(enhanced_files, reference_files, savefile=None,
                    compute_pesq=True, flag_rescore=False, n_workers=8,
                    verbose=False, align="guard", mesh=None):
    """Score a list of file pairs with caching.  Returns (S, labels):
    S is (n_files, 6).

    ``align``: "guard" (default -- the in-repo mask pipeline emits
    sample-aligned pairs) compensates a constant delay when one is
    detected; "full" runs the P.862-style unbounded + per-utterance host
    alignment on every pair (the general-scorer mode,
    scripts/score_audio.py); "off" scores pairs exactly as given.  Every
    path honors it: the packed engine compensates on device
    (engine.py), the per-file / mixed-fs / no-native fallbacks
    pre-align on the host with the same estimators
    (:func:`_apply_alignment`)."""
    if savefile is not None and os.path.isfile(savefile) and not flag_rescore:
        data = np.load(savefile)
        # the cache records the align mode it was scored under (files from
        # before the field behaved like "guard"); a mismatch silently
        # returning stale scores would make the align flag a no-op
        cached_align = (str(data["align"]) if "align" in data.files
                        else "guard")
        if cached_align == align:
            return data["S"], list(SCORE_LABELS)
        print(f"  rescoring {os.path.basename(savefile)}: cached under "
              f"align='{cached_align}', requested '{align}'")

    pairs = list(zip(enhanced_files, reference_files))

    from ..data.native_loader import native_available

    if native_available() and len(pairs) > 1:
        # decode ALL files through the multithreaded C++ batch loader (the
        # replacement for MATLAB's parfor worker pool, score_audio.m:72-98),
        # then run the PACKED engine: the device-side metrics
        # (SDR/SNR/SegSNR) for every pow2-length bucket cross the
        # host<->device boundary as ONE packed transfer + one batched
        # program per bucket (fused.fused_metrics_packed), dispatched
        # concurrently with a host thread pool computing PESQ/STOI;
        # bit-identical scores to the per-file pool.
        from ..data.native_loader import read_batch, read_batch_i16, wav_info
        from .fused import fused_metrics_packed

        # per-pair sample-rate check (header reads are cheap), preserving the
        # scipy path's fs-mismatch error semantics
        fs_ref = [wav_info(p)[2] for p in reference_files]
        fs_enh = [wav_info(p)[2] for p in enhanced_files]
        for i, (fr, fe) in enumerate(zip(fs_ref, fs_enh)):
            if fr != fe:
                raise ValueError(
                    f"fs mismatch: {fe} vs {fr} for {enhanced_files[i]}"
                )

        engine_path = len(set(fs_ref)) == 1 and fs_ref[0] == 16000
        if engine_path:
            # raw PCM16 decode: the engine dequantizes on device, halving
            # the dominant host->device transfer (engine.py docstring)
            i16 = read_batch_i16(list(enhanced_files))
            ref_i16 = read_batch_i16(list(reference_files)) if i16 else None
        if engine_path and i16 is not None and ref_i16 is not None:
            enh_data, enh_len = i16
            ref_data, ref_len = ref_i16
        else:
            enh_data, enh_len = read_batch(list(enhanced_files))
            ref_data, ref_len = read_batch(list(reference_files))

        ests = [enh_data[i, : enh_len[i]] for i in range(len(pairs))]
        refs = [ref_data[i, : ref_len[i]] for i in range(len(pairs))]

        if engine_path and mesh is not None and align in ("guard", "off"):
            # mesh-sharded engine: each pow2 bucket's file rows split over
            # the mesh axis (the parfor analog, score_audio.m:72-98) --
            # identical row-level scores to the single-chip engine
            from .sharded import score_all_sharded

            S, _ = score_all_sharded(ests, refs, mesh, fs=fs_ref[0],
                                     compute_pesq=compute_pesq, align=align)
            scores = list(S)
        elif engine_path:
            # the engine: PESQ and STOI run ON DEVICE alongside the fused
            # SDR/SNR/SegSNR program, sharing one packed transfer per
            # bucket -- no host metric math, no thread-pool serialization,
            # plus the integer-delay alignment guard
            from .engine import score_all_packed

            S, _ = score_all_packed(ests, refs, fs_ref[0],
                                    compute_pesq=compute_pesq, align=align)
            scores = list(S)
        elif len(set(fs_ref)) == 1:
            from .stoi import stoi_packed

            if align != "off":
                aligned = [_apply_alignment(ests[i], refs[i], fs_ref[i],
                                            align)
                           for i in range(len(pairs))]
                ests = [a[0] for a in aligned]
                refs = [a[1] for a in aligned]

            def pesq_job(i):
                n = min(len(ests[i]), len(refs[i]))
                return pesq_16k(refs[i][:n], ests[i][:n], fs_ref[i],
                                compute=compute_pesq)

            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                pesq_futs = [pool.submit(pesq_job, i)
                             for i in range(len(pairs))]
                # the fused SDR/SNR/SegSNR engine runs on its own worker so
                # its device programs overlap the STOI host stage below
                fused_fut = pool.submit(
                    fused_metrics_packed, ests, refs, fs_ref[0])
                # STOI: host stage (resample + silent-frame removal) fans
                # out on the same pool, device stage is packed per bucket
                stoi_vals = stoi_packed(refs, ests, fs_ref[0], pool=pool)
                dev = fused_fut.result()
                pesq_vals = [f.result() for f in pesq_futs]
            S = np.zeros((len(pairs), 6))
            S[:, :4] = dev
            S[:, 4] = pesq_vals
            S[:, 5] = stoi_vals
            scores = list(S)
        else:
            # mixed sample rates: SegSNR frame length differs per file, so
            # stream pairs through the per-file fused kernels instead
            def job(i):
                xe, xr = _apply_alignment(ests[i], refs[i], fs_ref[i],
                                          align)
                return _score_pair(xe, xr, fs_ref[i],
                                   compute_pesq=compute_pesq)

            scores = [job(0)]  # warm the jit caches
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                scores.extend(pool.map(job, range(1, len(pairs))))
    else:
        def job(pair):
            return compute_scores(pair[0], pair[1],
                                  compute_pesq=compute_pesq, align=align)

        # warm the jit caches on the first file, then stream the rest through
        # a small thread pool (decode overlaps device compute)
        scores = [job(pairs[0])]
        if len(pairs) > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                scores.extend(pool.map(job, pairs[1:]))
    S = np.stack(scores)

    if verbose:
        for label, val in zip(SCORE_LABELS, S.mean(axis=0)):
            print(f"  mean {label}: {val:.3f}")

    if savefile is not None:
        os.makedirs(os.path.dirname(os.path.abspath(savefile)), exist_ok=True)
        np.savez(savefile, S=S, labels=np.array(SCORE_LABELS, dtype="S"),
                 align=np.array(align))
    return S, list(SCORE_LABELS)


def score_dataset(dataset, description, snr_name=None, savefile=None,
                  datadir="", compute_pesq=True, flag_rescore=False,
                  verbose=False, mesh=None):
    """Score a dataset's enhanced outputs, optionally one SNR bucket.

    Mirrors AudioDataset.score_audio (audio_dataset.py:399-435): enhanced
    paths derive from the clean taskfile by the 'scaled'->'enhanced_<desc>'
    substitution; the SNR filter keeps files whose path contains
    '/<snr>/'.
    """
    y_wavfiles = list(dataset.y_wavfiles)
    if snr_name is None:
        refs = y_wavfiles
    else:
        refs = [w for w in y_wavfiles if f"/{snr_name}/" in w]
    enh = [w.replace("scaled", f"enhanced_{description}") for w in refs]

    if savefile is None:
        tag = description if snr_name is None else f"{description}_{snr_name}"
        savefile = os.path.join(datadir, "scores", f"scores_{tag}.npz")

    return score_taskfiles(
        enh, refs, savefile=savefile, compute_pesq=compute_pesq,
        flag_rescore=flag_rescore, verbose=verbose, mesh=mesh,
    )


def aggregate_snr_scores(per_snr_scores, n_wavfiles):
    """Sum raw scores over SNR buckets / total files (enhance.py:1405-1414)."""
    total = None
    for S, _ in per_snr_scores:
        s = np.sum(S, axis=0, keepdims=True)
        total = s if total is None else total + s
    return total / n_wavfiles

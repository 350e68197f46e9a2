"""Audio dataset layer: taskfiles -> STFT stacks -> cached tensors.

JAX reimplementation of the reference's ``AudioDataset``
(audio_dataset.py:172-435) and ``compute_STFTs`` (util.py:310-352):

* paired noisy(x)/clean(y) taskfiles, ``downsample`` keeps every nth file;
* per-file STFTs concatenated into a real-composite stack of shape
  ``(2*nch*F, total_frames)`` (real over imaginary) with per-file frame
  ranges ``fidx`` (n_files, 2);
* input lengths clipped to output lengths when they disagree
  (audio_dataset.py:233-242);
* HDF5 caching of the stacks keyed by the data file path (skipped when
  h5py is not installed);
* masked reconstruction: ratio mask tiled over the real/imag halves, applied
  to the complex STFT, inverse STFT, peak-safe wav write with the
  'scaled' -> 'enhanced_<desc>' path substitution (audio_dataset.py:267-339).

Featurization: wav decode happens on host (optionally through the native
C++ batch loader), but framing + rFFT run on device in length-bucketed
jit'd batches -- one compiled program per bucket instead of a per-file
interpreter loop.
"""

import os

import numpy as np

from ..dsp import wavread, wavwrite, sqrt_hann_periodic
from ..dsp.stft import (
    stft_frames,
    bucket_total as _bucket_total,
    n_frames_for_length,
)


def compute_stfts(wavfiles, params_stft, verbose=False, flag_unwrap_phase=False):
    """Featurize a list of wav files.

    Returns (stack, fidx): stack is the real-composite (2*nch*F, total_frames)
    float32 array, fidx (n_files, 2) int32 frame ranges -- the exact layout of
    the reference's ``compute_STFTs`` (util.py:310-352).  With
    ``flag_unwrap_phase`` the window-hop phases are removed per file before
    stacking (util.py:338-344).
    """
    import jax.numpy as jnp

    n_fft = int(params_stft["N"])
    hop = int(params_stft["hop"])
    nch = int(params_stft.get("nch", 1))
    window = params_stft.get("window")
    if window is None:
        window = sqrt_hann_periodic(n_fft)
    window = jnp.asarray(np.asarray(window, np.float32))
    f_bins = n_fft // 2 + 1

    wavfiles = list(wavfiles)
    nframes = []
    lengths = []
    use_native = False
    if nch == 1:
        from .native_loader import native_available

        use_native = native_available()
    if use_native:
        # header-only pass for lengths/bucketing; the audio itself is
        # decoded per batch chunk below, bounding peak host memory to one
        # chunk (a whole-corpus decode is (n_files, max_len) float32 --
        # ~7 GB at the 7k-file full-scale regime, an OOM risk on top of
        # the output stack)
        from .native_loader import read_batch, wav_info

        signals = None
        for wf in wavfiles:
            nsampl, _, _ = wav_info(wf)
            lengths.append(int(nsampl))
            nframes.append(n_frames_for_length(int(nsampl), n_fft, hop))
    else:
        # scipy fallback (multichannel or no native lib): scipy has no
        # header-only read, so decode up front as before
        signals = []
        for wf in wavfiles:
            x = wavread(wf)[:nch]  # (nch, nsampl)
            signals.append(x)
            lengths.append(x.shape[1])
            nframes.append(n_frames_for_length(x.shape[1], n_fft, hop))

    total = int(np.sum(nframes))
    stack = np.empty((2 * nch * f_bins, total), np.float32)
    fidx = np.zeros((len(wavfiles), 2), np.int32)

    # group files by bucketed length; one device batch per bucket
    buckets = {}
    for i, length in enumerate(lengths):
        buckets.setdefault(_bucket_total(length, n_fft, hop), []).append(i)

    cursor = 0
    for i, nf in enumerate(nframes):
        fidx[i, 0] = cursor
        cursor += nf
        fidx[i, 1] = cursor

    # fixed-shape batch chunks: each (chunk_B, total_len) pair is one
    # compiled program, with chunk_B restricted to pow2 <= FEAT_BATCH --
    # a 7k-file corpus otherwise compiles a fresh program per bucket's
    # exact file count.  The cap is floored to a pow2 so configured memory
    # bounds are honored exactly, and remainders split into descending
    # pow2 chunks so no dead padded rows are computed or fetched.
    feat_batch = max(1, int(os.environ.get("DRNMF_FEAT_BATCH", "64")))
    feat_batch = 1 << (feat_batch.bit_length() - 1)  # pow2 floor
    for total_len, idxs in sorted(buckets.items()):
        pos = 0
        while pos < len(idxs):
            remaining = len(idxs) - pos
            b = min(feat_batch, 1 << (remaining.bit_length() - 1))
            chunk = idxs[pos : pos + b]
            batch = np.zeros((b, nch, total_len), np.float32)
            # reference padding = n_fft zeros left + zeros to the bucket
            # right (pad_signal semantics) -- the batch is already zeros,
            # so these are pure host slice-assigns and the chunk crosses to
            # the device as one transfer.
            if use_native:
                # decode just this chunk's files (parallel C++ decoder)
                cdata, clens = read_batch([wavfiles[i] for i in chunk])
                for row in range(len(chunk)):
                    n = int(clens[row])
                    batch[row, 0, n_fft : n_fft + n] = cdata[row, :n]
            else:
                for row, i in enumerate(chunk):
                    x = np.asarray(signals[i], np.float32)
                    batch[row, :, n_fft : n_fft + x.shape[-1]] = x
            dev = stft_frames(jnp.asarray(batch), window, n_fft, hop)
            if flag_unwrap_phase:
                from ..dsp.phase import remove_hop_phase

                # hop-phase removal is causal along the frame axis (unwrap
                # = cumsum of wrapped diffs from frame 0), so applying it
                # to the whole left-aligned (b, nch, T, F) chunk and then
                # slicing the first nf frames per file equals the
                # reference's per-file application (util.py:338-344) --
                # one device op per chunk instead of one per file.
                dev = remove_hop_phase(dev, n_fft, hop)
            spec = np.asarray(dev)
            # spec: (B, nch, n_frames_bucket, F)
            for row, i in enumerate(chunk):
                nf = nframes[i]
                s = spec[row, :, :nf, :]  # (nch, nf, F)
                # reference layout: (F, nch, nfram) -> (nch*F, nfram)
                # Fortran order == channel-major stacking of F-rows;
                # equivalently for nch==1 it is just (F, nfram).
                s = np.transpose(s, (0, 2, 1)).reshape(nch * f_bins, nf)
                stack[: nch * f_bins, fidx[i, 0] : fidx[i, 1]] = s.real
                stack[nch * f_bins :, fidx[i, 0] : fidx[i, 1]] = s.imag
            pos += b
        if verbose:
            print(f"  featurized {len(idxs)} files at bucket {total_len}")

    return stack, fidx


def clip_x_to_y(x_stack, y_stack, x_fidx, y_fidx):
    """Clip per-utterance input frame ranges to output lengths
    (audio_dataset.py:90-104 semantics)."""
    y_lens = y_fidx[:, 1] - y_fidx[:, 0]
    n_utt = x_fidx.shape[0]
    out = np.empty((x_stack.shape[0], int(np.sum(y_lens))), x_stack.dtype)
    idx = 0
    for i in range(n_utt):
        xcur = x_stack[:, x_fidx[i, 0] : x_fidx[i, 1]]
        out[:, idx : idx + y_lens[i]] = xcur[:, : y_lens[i]]
        idx += y_lens[i]
    return out


def _h5py():
    """The h5py module, or None when it is not installed; the HDF5 feature
    cache is then skipped, with one printed line."""
    try:
        import h5py
    except ImportError:
        print("h5py is not installed: skipping the HDF5 feature cache",
              flush=True)
        return None
    return h5py


def _read_taskfile(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class AudioDataset:
    """Paired noisy/clean STFT dataset with HDF5 caching.

    Parameters mirror the reference class (audio_dataset.py:189-196):
    ``params_stft`` keys 'N', 'hop', 'nch' (a sqrt-Hann periodic window is
    always used), ``downsample`` keeps every nth taskfile line.
    """

    def __init__(self, taskfile_input, taskfile_output, datafile=None,
                 params_stft=None, downsample=1, verbose=False,
                 flag_unwrap_phase=False):
        if params_stft is None:
            params_stft = {"N": 512, "hop": 128, "nch": 1}
        self.taskfile_input = taskfile_input
        self.taskfile_output = taskfile_output
        self.datafile = datafile
        self.params_stft = dict(params_stft)
        self.params_stft["window"] = sqrt_hann_periodic(int(params_stft["N"]))
        self.downsample = downsample
        self.verbose = verbose
        self.flag_unwrap_phase = flag_unwrap_phase
        self._fs = None
        self._load()

    @property
    def fs(self):
        """Corpus sample rate, read once from the first clean wav.  Falls
        back to 16 kHz (the CHiME2 rate) when no wav is reachable, e.g. a
        dataset restored purely from an HDF5 cache built elsewhere."""
        if self._fs is None:
            try:
                from ..dsp.wav import wavread_fs

                self._fs = int(wavread_fs(self.y_wavfiles[0])[1])
            except (OSError, IndexError, ValueError):
                self._fs = 16000
        return self._fs

    def _load(self):
        datafile = self.datafile
        h5py = _h5py() if datafile is not None else None
        if h5py is not None and os.path.isfile(datafile):
            with h5py.File(datafile, "r") as f:
                if "stft" in f:
                    # guard against silently loading a cache built with a
                    # different featurization setup under the same name
                    want_by_key = {
                        "N": int(self.params_stft["N"]),
                        "hop": int(self.params_stft["hop"]),
                        "nch": int(self.params_stft.get("nch", 1)),
                        "unwrap": int(bool(self.flag_unwrap_phase)),
                        "downsample": int(self.downsample),
                    }
                    for key, want in want_by_key.items():
                        if key not in f["stft"].attrs:
                            if key in ("unwrap", "downsample"):
                                continue  # legacy cache predating the attr
                            cached = -1
                        else:
                            cached = int(f["stft"].attrs[key])
                        if cached != want:
                            raise ValueError(
                                f"datafile {datafile} was built with "
                                f"{key}={cached}, requested {key}={want}; "
                                "delete the cache or use a different "
                                "datafile name"
                            )
                self.x_stack = f["x_stack"][:]
                self.y_stack = f["y_stack"][:]
                self.fidx = f["fidx"][:]
                self.x_wavfiles = [
                    s.decode() if isinstance(s, bytes) else s for s in f["x_wavfiles"][:]
                ]
                self.y_wavfiles = [
                    s.decode() if isinstance(s, bytes) else s for s in f["y_wavfiles"][:]
                ]
            # the file LISTS are the ground truth for what the cache holds:
            # when the taskfiles are reachable, the downsampled selection
            # must match what was cached (catches a cache built from
            # different taskfiles -- or a different downsample predating
            # the attr -- reused under the same datafile name)
            try:
                want_x = _read_taskfile(self.taskfile_input)[:: self.downsample]
            except (OSError, TypeError):
                want_x = None  # cache restored where taskfiles don't exist
            if want_x is not None and want_x != self.x_wavfiles:
                raise ValueError(
                    f"datafile {datafile} holds {len(self.x_wavfiles)} "
                    f"files that do not match the {len(want_x)} selected "
                    f"by {self.taskfile_input} at downsample="
                    f"{self.downsample}; delete the cache or use a "
                    "different datafile name"
                )
            return

        x_wavfiles = _read_taskfile(self.taskfile_input)[:: self.downsample]
        y_wavfiles = _read_taskfile(self.taskfile_output)[:: self.downsample]

        x_stack, x_fidx = compute_stfts(x_wavfiles, self.params_stft, self.verbose,
                                        flag_unwrap_phase=self.flag_unwrap_phase)
        y_stack, y_fidx = compute_stfts(y_wavfiles, self.params_stft, self.verbose,
                                        flag_unwrap_phase=self.flag_unwrap_phase)

        if not np.array_equal(x_fidx, y_fidx):
            if np.all(x_fidx[:, 1] - x_fidx[:, 0] >= y_fidx[:, 1] - y_fidx[:, 0]):
                x_stack = clip_x_to_y(x_stack, y_stack, x_fidx, y_fidx)
            else:
                raise ValueError(
                    "Not all input files are at least as long as the outputs"
                )
        fidx = y_fidx

        self.x_stack, self.y_stack, self.fidx = x_stack, y_stack, fidx
        self.x_wavfiles, self.y_wavfiles = x_wavfiles, y_wavfiles

        if h5py is not None:
            with h5py.File(datafile, "w") as f:
                f.create_dataset("x_stack", data=x_stack)
                f.create_dataset("y_stack", data=y_stack)
                f.create_dataset("fidx", data=fidx)
                f.create_dataset("x_wavfiles", data=np.array(x_wavfiles, dtype="S"))
                f.create_dataset("y_wavfiles", data=np.array(y_wavfiles, dtype="S"))
                grp = f.create_group("stft")
                grp.attrs["N"] = int(self.params_stft["N"])
                grp.attrs["hop"] = int(self.params_stft["hop"])
                grp.attrs["nch"] = int(self.params_stft.get("nch", 1))
                grp.attrs["unwrap"] = int(bool(self.flag_unwrap_phase))
                grp.attrs["downsample"] = int(self.downsample)

    # -- reconstruction ----------------------------------------------------

    def _reconstruct(self, stack, idx, mask=None):
        from ..dsp import istft
        import jax.numpy as jnp

        n_fft = int(self.params_stft["N"])
        hop = int(self.params_stft["hop"])
        window = self.params_stft["window"]
        seg = stack[:, self.fidx[idx, 0] : self.fidx[idx, 1]]
        if mask is not None:
            if mask.shape[0] < seg.shape[0]:
                mask = np.tile(mask, (seg.shape[0] // mask.shape[0], 1))
            seg = mask * seg
        half = seg.shape[0] // 2
        spec = seg[:half] + 1j * seg[half:]  # (nch*F, nfram)
        f_bins = n_fft // 2 + 1
        nch = half // f_bins
        nfram = spec.shape[1]
        spec = spec.reshape(nch, f_bins, nfram).transpose(0, 2, 1)  # (nch, T, F)
        xr = np.asarray(istft(spec.astype(np.complex64), n_fft, hop,
                              jnp.asarray(window)))
        return xr  # (nch, nsampl)

    def reconstruct_x(self, idx, mask=None):
        return self._reconstruct(self.x_stack, idx, mask)

    def reconstruct_y(self, idx, mask=None):
        return self._reconstruct(self.y_stack, idx, mask)

    def enhanced_path(self, idx, description):
        return self.y_wavfiles[idx].replace("scaled", f"enhanced_{description}")

    def reconstruct_audio(self, description, irm=None, mask=None, idx=None,
                          test=False, fs=None):
        """Write enhanced wavs (or report NMSE in test mode).

        Mirrors audio_dataset.py:294-339: ``irm`` may be (n_seq, T, F) with a
        matching binary ``mask``, or a per-utterance (F, n_frames) array when
        ``idx`` is a single int.  ``fs`` defaults to the corpus rate.
        """
        if fs is None:
            fs = self.fs
        if idx is None:
            idx = list(range(len(self.x_wavfiles)))
        if irm is not None and mask is not None and \
                len(irm) != len(self.x_wavfiles):
            # sequence row j must BE utterance j: tensors built with maxlen
            # chunking have n_seq > n_files and would silently mask the
            # wrong files (the reference had the same implicit contract --
            # audio_dataset.py:294-339 -- but never exposed maxlen here)
            raise ValueError(
                f"irm has {len(irm)} sequence rows but the corpus has "
                f"{len(self.x_wavfiles)} files; tensors built with maxlen "
                "chunking cannot drive reconstruction -- rebuild them with "
                "maxlen=None (one full-length row per wav file, as "
                "pipeline.reconstruct_split does)"
            )
        if isinstance(idx, (list, tuple, np.ndarray)):
            results = []
            for j in idx:
                m = None
                if irm is not None and mask is not None:
                    m = irm[j, : int(np.sum(mask[j])), :].T
                    nf = int(self.fidx[j, 1] - self.fidx[j, 0])
                    if m.shape[1] != nf:
                        raise ValueError(
                            f"mask row {j} covers {m.shape[1]} frames but "
                            f"utterance {j} has {nf}: the tensors were "
                            "built with a truncating maxlen; rebuild with "
                            "maxlen=None for reconstruction"
                        )
                yest = self.reconstruct_x(j, mask=m)
                if test:
                    x = wavread(self.x_wavfiles[j])[0:1]
                    yest_c = yest[:, : x.shape[1]]
                    nmse = float(np.mean((x - yest_c) ** 2) / np.mean(x**2))
                    results.append(nmse)
                else:
                    out = self.enhanced_path(j, description)
                    os.makedirs(os.path.dirname(out), exist_ok=True)
                    wavwrite(out, fs, yest)
            return results if test else None
        # single utterance with an (F, n_frames) mask
        yest = self.reconstruct_x(idx, mask=irm)
        out = self.enhanced_path(idx, description)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        wavwrite(out, fs, yest)

    # -- tensors -----------------------------------------------------------

    def get_padded_data_matrix(self, transform_x=None, transform_y=None,
                               pad_value=0.0, maxlen=None):
        from .batching import reshape_and_pad_stacks

        return reshape_and_pad_stacks(
            self.x_stack, self.y_stack, self.fidx,
            transform_x=transform_x, transform_y=transform_y,
            pad_value=pad_value, maxlen=maxlen,
        )

"""Data layer tests: featurization, caching, chunking, reconstruction."""

import numpy as np
import pytest

from drnmf_tpu.data import (
    AudioDataset,
    make_synthetic_corpus,
    reshape_and_pad_stacks,
    masked_seqs_to_frames,
    make_transform,
    get_mask_value,
    load_split,
    pad_axis_to_n,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    taskfiles = make_synthetic_corpus(str(root), n_files=8, max_sec=1.2)
    return root, taskfiles


@pytest.fixture(scope="module")
def dataset(corpus):
    root, taskfiles = corpus
    return AudioDataset(
        taskfiles["noisy"], taskfiles["clean"],
        datafile=str(root / "cache.h5"),
        params_stft={"N": 512, "hop": 128, "nch": 1},
    )


def test_stack_shapes_and_fidx(dataset):
    assert dataset.x_stack.shape[0] == 2 * 257
    assert dataset.y_stack.shape == dataset.x_stack.shape
    fidx = np.asarray(dataset.fidx)
    assert fidx.shape == (8, 2)
    assert fidx[0, 0] == 0
    assert np.all(fidx[1:, 0] == fidx[:-1, 1])
    assert fidx[-1, 1] == dataset.x_stack.shape[1]


def test_featurization_matches_single_file_stft(dataset, corpus):
    """Stack columns for file j must equal a direct STFT of that file."""
    from drnmf_tpu.dsp import stft, wavread, sqrt_hann_periodic

    j = 3
    x = wavread(dataset.x_wavfiles[j])[0]
    spec = np.asarray(stft(x, 512, 128, sqrt_hann_periodic(512)))  # (T, F)
    seg = dataset.x_stack[:, dataset.fidx[j, 0] : dataset.fidx[j, 1]]
    np.testing.assert_allclose(seg[:257], spec.T.real, atol=1e-5)
    np.testing.assert_allclose(seg[257:], spec.T.imag, atol=1e-5)


def test_hdf5_cache_roundtrip(dataset, corpus):
    root, taskfiles = corpus
    d2 = AudioDataset(
        taskfiles["noisy"], taskfiles["clean"],
        datafile=str(root / "cache.h5"),
        params_stft={"N": 512, "hop": 128, "nch": 1},
    )
    np.testing.assert_array_equal(d2.x_stack, dataset.x_stack)
    np.testing.assert_array_equal(d2.fidx, dataset.fidx)
    assert list(d2.x_wavfiles) == list(dataset.x_wavfiles)


def test_featurization_without_h5py_matches_cached(dataset, corpus,
                                                  monkeypatch, capsys):
    """Without h5py the HDF5 cache is skipped with one printed line and no
    file; the features equal those the cached dataset holds."""
    import sys

    root, taskfiles = corpus
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = root / "no_h5py.h5"
    d2 = AudioDataset(taskfiles["noisy"], taskfiles["clean"],
                      datafile=str(path),
                      params_stft={"N": 512, "hop": 128, "nch": 1})
    out = capsys.readouterr().out
    assert out.count("h5py is not installed") == 1
    assert not path.exists()
    np.testing.assert_array_equal(d2.x_stack, dataset.x_stack)
    np.testing.assert_array_equal(d2.y_stack, dataset.y_stack)
    np.testing.assert_array_equal(d2.fidx, dataset.fidx)


def test_reconstruct_passthrough_nmse(dataset):
    """STFT -> iSTFT passthrough NMSE, the reference's smoke test
    (test_audio_dataset.py:78-91, expected ~1e-7)."""
    nmses = dataset.reconstruct_audio("t", idx=[0, 1, 2], test=True)
    assert all(n < 1e-6 for n in nmses), nmses


def test_dataset_fs_from_corpus(tmp_path):
    """The corpus sample rate is read from the first wav, so enhanced wavs
    off-CHiME2 (non-16k) carry the right header rate."""
    import scipy.io.wavfile

    tf = make_synthetic_corpus(str(tmp_path / "a8k"), n_files=2, fs=8000,
                               min_sec=0.4, max_sec=0.6)
    ds = AudioDataset(tf["noisy"], tf["clean"],
                      params_stft={"N": 256, "hop": 64, "nch": 1})
    assert ds.fs == 8000
    ds.reconstruct_audio("fs_test", idx=0)
    out = ds.enhanced_path(0, "fs_test")
    fs_written, _ = scipy.io.wavfile.read(out)
    assert fs_written == 8000


def test_reconstruct_with_mask_attenuates(dataset):
    y_full = dataset.reconstruct_x(0)
    nfram = dataset.fidx[0, 1] - dataset.fidx[0, 0]
    half_mask = 0.5 * np.ones((257, nfram), np.float32)
    y_half = dataset.reconstruct_x(0, mask=half_mask)
    np.testing.assert_allclose(y_half, 0.5 * y_full, atol=1e-6)


def test_chunking_semantics():
    """reshape_and_pad_stacks must reproduce the reference's cursor walk."""
    f2 = 6
    fidx = np.array([[0, 7], [7, 10], [10, 22]])
    stack = np.arange(22 * f2, dtype=np.float32).reshape(f2, 22)
    x, y, mask = reshape_and_pad_stacks(stack, stack, fidx, maxlen=5)
    # file lens 7,3,12 -> ceil(7/5)+ceil(3/5)+ceil(12/5) = 2+1+3 = 6 sequences
    assert x.shape == (6, 5, f2)
    # sequence 0: frames 0..4; sequence 1: frames 5..6 (then bump)
    np.testing.assert_array_equal(x[0, :, 0], stack[0, 0:5])
    np.testing.assert_array_equal(x[1, :2, 0], stack[0, 5:7])
    assert np.all(mask[1, 2:] == 0)
    # sequence 2: file 1 frames 7..9
    np.testing.assert_array_equal(x[2, :3, 0], stack[0, 7:10])
    # sequences 3..5: file 2 frames 10..21
    np.testing.assert_array_equal(x[3, :, 0], stack[0, 10:15])
    np.testing.assert_array_equal(x[5, :2, 0], stack[0, 20:22])


def test_no_maxlen_pads_to_maxseq():
    f2 = 4
    fidx = np.array([[0, 3], [3, 10]])
    stack = np.ones((f2, 10), np.float32)
    x, y, mask = reshape_and_pad_stacks(stack, stack, fidx, pad_value=-1.0)
    assert x.shape == (2, 7, f2)
    assert np.all(x[0, 3:] == -1.0)
    assert mask[0, :3].all() and not mask[0, 3:].any()


def test_transforms_and_mask_value():
    s = np.array([[3.0], [0.0], [4.0], [0.0]], np.float32)  # re=[3,0], im=[4,0]
    mag = make_transform("mag")(s)
    np.testing.assert_allclose(mag, [[5.0], [0.0]])
    logmag = make_transform("logmag")(s)
    np.testing.assert_allclose(logmag, np.log(1 + mag))
    assert get_mask_value("mag", "mag") == -1.0
    assert get_mask_value("none", "logmag") == -1.0
    assert get_mask_value("none", "none") == 0.0


def test_masked_seqs_to_frames_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    mask = np.ones((2, 5, 1), np.float32)
    mask[0, 3:] = 0
    mask[1, 4:] = 0
    frames = masked_seqs_to_frames(x, mask)
    assert frames.shape == (3, 7)
    np.testing.assert_array_equal(frames[:, :3], x[0, :3].T)
    np.testing.assert_array_equal(frames[:, 3:], x[1, :4].T)


def test_load_split(dataset):
    x, y, mask = load_split(dataset, "mag", "mag", maxlen=50)
    assert x.shape == y.shape
    assert x.shape[1] <= 50
    assert x.shape[2] == 257
    assert np.all(x[mask[..., 0] > 0] >= 0)  # magnitudes are nonnegative
    # padding value is -1 for mag transforms
    if np.any(mask == 0):
        assert np.all(x[mask[..., 0] == 0] == -1.0)


def test_pad_axis_to_n():
    x = np.ones((2, 3, 4), np.float32)
    out = pad_axis_to_n(x, 1, 5, -1.0)
    assert out.shape == (2, 5, 4)
    assert np.all(out[:, 3:] == -1.0)


def test_featurize_bounded_device_dispatches(tmp_path, rng, monkeypatch):
    """compute_stfts issues ONE device program per fixed-shape batch chunk
    (pow2 rows <= DRNMF_FEAT_BATCH) -- never per file -- and pads on host.
    At 7,138-file corpus scale a per-file jnp pad is two device programs
    per file, and a per-bucket exact-count batch is a fresh XLA compile
    per bucket."""
    from drnmf_tpu.dsp import wavwrite
    from drnmf_tpu.data import dataset as ds_mod

    n_fft, hop = 256, 64
    files = []
    for i in range(9):  # same length -> one bucket
        p = tmp_path / f"f{i}.wav"
        wavwrite(str(p), 16000,
                 (rng.standard_normal(3000) * 0.2).astype(np.float32)[None])
        files.append(str(p))

    calls = []
    real = ds_mod.stft_frames

    def counting(batch, window, n, h):
        calls.append(tuple(batch.shape))
        return real(batch, window, n, h)

    monkeypatch.setattr(ds_mod, "stft_frames", counting)
    monkeypatch.setenv("DRNMF_FEAT_BATCH", "4")
    stack, fidx = ds_mod.compute_stfts(files, {"N": n_fft, "hop": hop,
                                               "nch": 1})
    # 9 equal-length files at chunk cap 4 -> chunks of 4, 4, 1 (pow2 rows)
    assert [c[0] for c in calls] == [4, 4, 1]
    # correctness unchanged: single-file featurization matches row-for-row
    monkeypatch.setattr(ds_mod, "stft_frames", real)
    one, _ = ds_mod.compute_stfts(files[:1], {"N": n_fft, "hop": hop,
                                              "nch": 1})
    np.testing.assert_allclose(stack[:, : fidx[0, 1]], one, rtol=1e-5,
                               atol=1e-6)


def test_featurize_unwrap_phase_chunked_matches_per_file(tmp_path, rng,
                                                         monkeypatch):
    """flag_unwrap_phase applied once per device chunk equals the
    reference's per-file application (util.py:338-344): hop-phase removal
    is causal along frames, so batching over left-aligned padded rows and
    slicing the first nf frames is exact."""
    from drnmf_tpu.dsp import wavwrite
    from drnmf_tpu.data.dataset import compute_stfts

    n_fft, hop = 256, 64
    files = []
    for i in range(3):  # varied lengths -> padded rows inside one bucket
        p = tmp_path / f"u{i}.wav"
        wavwrite(str(p), 16000,
                 (rng.standard_normal(2800 + 130 * i) * 0.2)
                 .astype(np.float32)[None])
        files.append(str(p))

    monkeypatch.setenv("DRNMF_FEAT_BATCH", "4")
    stack, fidx = compute_stfts(files, {"N": n_fft, "hop": hop, "nch": 1},
                                flag_unwrap_phase=True)
    for i, f in enumerate(files):
        one, _ = compute_stfts([f], {"N": n_fft, "hop": hop, "nch": 1},
                               flag_unwrap_phase=True)
        np.testing.assert_allclose(stack[:, fidx[i, 0]: fidx[i, 1]], one,
                                   rtol=1e-4, atol=1e-5)


def test_multichannel_stack_layout(tmp_path, rng):
    """nch=2 featurization stacks channels channel-major ((F rows of ch0,
    then F rows of ch1), the reference's F-major 'F'-order reshape,
    util.py:333-336) and reconstruction inverts it."""
    from drnmf_tpu.dsp import wavwrite
    from drnmf_tpu.data.dataset import compute_stfts

    n_fft, hop = 256, 64
    f_bins = n_fft // 2 + 1
    ch0 = (rng.standard_normal(4000) * 0.2).astype(np.float32)
    ch1 = (rng.standard_normal(4000) * 0.1).astype(np.float32)
    stereo = tmp_path / "st.wav"
    wavwrite(str(stereo), 16000, np.stack([ch0, ch1]))
    mono0 = tmp_path / "m0.wav"
    mono1 = tmp_path / "m1.wav"
    wavwrite(str(mono0), 16000, ch0[None])
    wavwrite(str(mono1), 16000, ch1[None])

    params2 = {"N": n_fft, "hop": hop, "nch": 2}
    params1 = {"N": n_fft, "hop": hop, "nch": 1}
    stack2, fidx2 = compute_stfts([str(stereo)], params2)
    s0, _ = compute_stfts([str(mono0)], params1)
    s1, _ = compute_stfts([str(mono1)], params1)

    assert stack2.shape[0] == 2 * 2 * f_bins
    nfr = fidx2[0, 1]
    half = 2 * f_bins  # complex halves offset
    # real parts: rows [0:F]=ch0, [F:2F]=ch1
    np.testing.assert_allclose(stack2[:f_bins, :nfr], s0[:f_bins, :nfr],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stack2[f_bins : 2 * f_bins, :nfr],
                               s1[:f_bins, :nfr], rtol=1e-4, atol=1e-5)
    # imag parts
    np.testing.assert_allclose(stack2[half : half + f_bins, :nfr],
                               s0[f_bins:, :nfr], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stack2[half + f_bins :, :nfr],
                               s1[f_bins:, :nfr], rtol=1e-4, atol=1e-5)


def test_mask_value_semantics():
    from drnmf_tpu.data.batching import get_mask_value

    assert get_mask_value("mag", "mag") == -1.0
    assert get_mask_value("logmag", "logmag") == -1.0
    assert get_mask_value("logmag", "mag") == -1.0  # reference quirk fixed
    assert get_mask_value("identity", "identity") == 0.0


def test_datafile_cache_validates_stft_params(tmp_path, rng):
    from drnmf_tpu.data import AudioDataset, make_synthetic_corpus
    import pytest

    tf = make_synthetic_corpus(str(tmp_path / "a"), n_files=2,
                               min_sec=0.3, max_sec=0.4)
    datafile = str(tmp_path / "cache.hdf5")
    AudioDataset(tf["noisy"], tf["clean"], datafile=datafile,
                 params_stft={"N": 256, "hop": 64, "nch": 1})
    # same datafile, different STFT setup -> hard error, not silent reuse
    with pytest.raises(ValueError, match="was built with"):
        AudioDataset(tf["noisy"], tf["clean"], datafile=datafile,
                     params_stft={"N": 512, "hop": 128, "nch": 1})


def test_datafile_cache_validates_downsample_and_lists(tmp_path):
    """A cache built at one downsample (or from other taskfiles) must not
    be silently reused: both the stored attr and the cached wavfile lists
    are checked against the requested selection."""
    from drnmf_tpu.data import AudioDataset, make_synthetic_corpus
    import pytest

    tf = make_synthetic_corpus(str(tmp_path / "a"), n_files=4,
                               min_sec=0.3, max_sec=0.4)
    stft = {"N": 256, "hop": 64, "nch": 1}
    datafile = str(tmp_path / "cache.hdf5")
    AudioDataset(tf["noisy"], tf["clean"], datafile=datafile,
                 params_stft=stft, downsample=1)
    # same datafile, different downsample -> hard error, not a silent
    # full-corpus load posing as the downsampled one
    with pytest.raises(ValueError, match="downsample"):
        AudioDataset(tf["noisy"], tf["clean"], datafile=datafile,
                     params_stft=stft, downsample=2)
    # different taskfile content under the same datafile name -> error
    tf2 = make_synthetic_corpus(str(tmp_path / "b"), n_files=4,
                                min_sec=0.3, max_sec=0.4)
    with pytest.raises(ValueError, match="do not match"):
        AudioDataset(tf2["noisy"], tf2["clean"], datafile=datafile,
                     params_stft=stft, downsample=1)
    # the matching setup still cache-hits
    d = AudioDataset(tf["noisy"], tf["clean"], datafile=datafile,
                     params_stft=stft, downsample=1)
    assert len(d.x_wavfiles) == 4


def test_reconstruct_audio_rejects_chunked_tensors(dataset):
    """Tensors built with a truncating maxlen (n_seq > n_files) silently
    mapped masks to the wrong files in the reference; here it is a hard
    error directing the caller to maxlen=None rows."""
    import pytest

    x, y, mask = dataset.get_padded_data_matrix(maxlen=4)
    assert x.shape[0] > len(dataset.x_wavfiles)  # chunked: more rows
    irm = np.ones(x.shape, np.float32)
    with pytest.raises(ValueError, match="maxlen"):
        dataset.reconstruct_audio("chunked", irm=irm,
                                  mask=(mask != 0).astype(np.float32))


def test_native_loader_stale_so_falls_back(monkeypatch):
    """A dlopen'd library missing base symbols (stale prebuilt .so, no
    toolchain to freshen it) must report unavailable -> scipy fallback,
    not crash mid-featurization."""
    from drnmf_tpu.data import native_loader as nl

    class _NoSymbols:
        def __getattr__(self, name):  # every symbol lookup fails
            raise AttributeError(name)

    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_lib_failed", False)
    monkeypatch.setattr(nl.ctypes, "CDLL", lambda path: _NoSymbols())
    monkeypatch.setattr(nl, "ensure_built", lambda quiet=True: True)
    assert nl.get_lib() is None
    assert nl.native_available() is False
    assert nl._lib_failed is True  # sentinel set: no retry/warn spam

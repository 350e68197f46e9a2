"""ctypes bindings for the native batch wav loader (native/wavio.cpp).

Falls back to the scipy-based reader transparently when the shared library
is missing; ``ensure_built()`` compiles it on demand with the in-image g++.
"""

import ctypes
import os
import subprocess

import numpy as np

# Source checkout layout: <repo>/native next to the package.  Installed
# wheels don't ship the C++ source; point DRNMF_NATIVE_DIR at a checkout's
# native/ (or any dir with the Makefile/prebuilt .so) to keep the fast path.
_NATIVE_DIR = os.environ.get(
    "DRNMF_NATIVE_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "native"),
)
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libdrnmfio.so"))

_lib = None
_lib_failed = False  # stale .so detected: don't re-warn on every call


def ensure_built(quiet=True):
    """Build (or freshen) libdrnmfio.so.  Returns True when available.

    Always invokes make (mtime-based, a no-op when current): an .so built
    from older sources -- e.g. before wav_read_batch_i16 existed -- would
    otherwise be dlopen'd as-is and silently disable newer fast paths."""
    try:
        subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR)],
            check=True,
            capture_output=quiet,
        )
    except Exception:
        pass  # no toolchain: a prebuilt .so is still usable
    return os.path.exists(_SO_PATH)


def get_lib():
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed or not ensure_built():
        return None
    lib = ctypes.CDLL(_SO_PATH)
    try:
        _bind(lib)
    except AttributeError as e:
        # a prebuilt .so from older sources (no toolchain to freshen it):
        # missing BASE symbols mean the library is unusable -- report it
        # unavailable so callers take the scipy fallback path the module
        # docstring promises, instead of crashing mid-featurization
        print(f"WARNING: stale libdrnmfio.so ({e}); using the scipy wav "
              "reader (rebuild native/)", flush=True)
        _lib_failed = True
        return None
    _lib = lib
    return lib


def _bind(lib):
    lib.wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
        ctypes.c_int64,
    ]
    lib.wav_read.restype = ctypes.c_int
    lib.wav_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.wav_read_batch.restype = ctypes.c_int
    lib.wav_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.wav_write.restype = ctypes.c_int
    if not hasattr(lib, "wav_read_batch_i16"):
        # make should have rebuilt a stale .so before the dlopen above, so
        # reaching here means the build itself is out of date somehow
        print("WARNING: libdrnmfio.so lacks wav_read_batch_i16; scoring "
              "falls back to float32 transfers (rebuild native/)",
              flush=True)
    if hasattr(lib, "wav_read_batch_i16"):
        lib.wav_read_batch_i16.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.wav_read_batch_i16.restype = ctypes.c_int


def native_available() -> bool:
    return get_lib() is not None


def wav_info(path):
    lib = get_lib()
    nsampl = ctypes.c_int64()
    nch = ctypes.c_int32()
    fs = ctypes.c_int32()
    rc = lib.wav_info(path.encode(), ctypes.byref(nsampl), ctypes.byref(nch),
                      ctypes.byref(fs))
    if rc != 0:
        raise IOError(f"wav_info failed ({rc}) for {path}")
    return int(nsampl.value), int(nch.value), int(fs.value)


def read_batch(paths, n_threads=0):
    """Parallel-decode channel 0 of many wav files.

    Returns (data (n, max_len) float32 zero-padded, lengths (n,) int64).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader not built")
    n = len(paths)
    max_len = 0
    for p in paths:
        nsampl, _, _ = wav_info(p)
        max_len = max(max_len, nsampl)
    data = np.zeros((n, max_len), np.float32)
    lengths = np.zeros(n, np.int64)
    rcs = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bad = lib.wav_read_batch(
        c_paths,
        n,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if bad:
        failed = [paths[i] for i in range(n) if rcs[i] != 0]
        raise IOError(f"{bad} wav decodes failed, first: {failed[:3]}")
    return data, lengths


def read_batch_i16(paths, n_threads=0):
    """Parallel-decode channel 0 as RAW PCM16 (no float conversion).

    Returns (data (n, max_len) int16 zero-padded, lengths (n,) int64).
    The scoring engine ships these bytes to the device and dequantizes
    there (x * 1/32768, identical values to the float path) -- HALF the
    host->device transfer bytes.  Requires a libdrnmfio.so built with
    wav_read_batch_i16
    (ensure_built rebuilds on demand); returns None if unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "wav_read_batch_i16"):
        return None
    n = len(paths)
    max_len = 0
    for p in paths:
        nsampl, _, _ = wav_info(p)
        max_len = max(max_len, nsampl)
    data = np.zeros((n, max_len), np.int16)
    lengths = np.zeros(n, np.int64)
    rcs = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bad = lib.wav_read_batch_i16(
        c_paths,
        n,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        max_len,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if bad:
        failed = [paths[i] for i in range(n) if rcs[i] != 0]
        raise IOError(f"{bad} wav decodes failed, first: {failed[:3]}")
    return data, lengths

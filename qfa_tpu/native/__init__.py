"""Native runtime components (C++, ctypes-bound).

The batch spectra reader compiles on first use (g++ -O3) and is loaded
through ctypes — no build-system or pybind11 dependency. The library is
named by a hash of its source and the machine's architecture and kept in
the gitignored ``_build/`` directory beside it, so a library is only ever
loaded for the exact source it was built from. Everything degrades
gracefully: if no compiler is available the data layer falls back to the
pure-Python reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

__all__ = [
    "native_available",
    "read_spectra_native",
    "build_library",
    "library_path",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "npz_reader.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False
_build_error: str | None = None  #: first build/load failure, for diagnostics


def library_path() -> str:
    """Where the library built from the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(platform.machine().encode())
    return os.path.join(
        _BUILD_DIR, f"libqfa_native-{digest.hexdigest()[:16]}.so"
    )


def build_library(force: bool = False) -> str:
    """Compile the native reader (idempotent); returns the .so path.

    The compiler writes to a temporary name that is renamed into place, so
    concurrent builders (test workers) never load a half-written file.
    """
    lib = library_path()
    with _lock:
        if force or not os.path.exists(lib):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                cmd = [
                    "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    "-o", tmp, _SRC, "-lz", "-lpthread",
                ]
                subprocess.run(cmd, check=True, capture_output=True, text=True)
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    try:
        path = build_library()
        lib = ctypes.CDLL(path)
        lib.qfa_read_spectra.restype = ctypes.c_int
        lib.qfa_read_spectra.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int,  # n_files
            ctypes.c_int,  # npix
            ctypes.POINTER(ctypes.c_float),  # flux
            ctypes.POINTER(ctypes.c_float),  # error
            ctypes.POINTER(ctypes.c_uint8),  # mask
            ctypes.POINTER(ctypes.c_uint8),  # flux_ok
            ctypes.POINTER(ctypes.c_float),  # z
            ctypes.c_int,  # n_threads
            ctypes.c_char_p,  # errbuf
            ctypes.c_int,  # errbuf_len
        ]
        _lib = lib
        return lib
    except (subprocess.CalledProcessError, OSError) as e:
        global _build_error
        _build_failed = True
        # keep the compiler's own message: "no compiler?" is useless when
        # g++ exists but compilation failed (missing zlib headers, ...)
        detail = getattr(e, "stderr", None) or str(e)
        _build_error = str(detail).strip()[-1000:]
        return None


def native_available() -> bool:
    """Whether the native reader can be built/loaded on this machine."""
    return _load() is not None


def read_spectra_native(
    paths, npix: int, n_threads: int = 16
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read many spectra npz files via the C++ thread pool.

    Returns (flux, error, mask, z, flux_ok) with flux/error float32
    (N, npix), mask/flux_ok bool (N, npix), z float32 (N,) — identical
    contract to the Python reader (``qfa_tpu.data.loader.read_spectra``).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native reader unavailable"
            + (f": {_build_error}" if _build_error else " (no compiler?)")
        )
    n = len(paths)
    flux = np.empty((n, npix), np.float32)
    error = np.empty((n, npix), np.float32)
    mask = np.empty((n, npix), np.uint8)
    flux_ok = np.empty((n, npix), np.uint8)
    z = np.empty((n,), np.float32)
    encoded = [os.fsencode(p) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*encoded)
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.qfa_read_spectra(
        c_paths,
        n,
        npix,
        flux.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        error.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        flux_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
        errbuf,
        len(errbuf),
    )
    if rc != 0:
        raise IOError(
            f"native reader: {rc}/{n} files failed "
            f"({errbuf.value.decode(errors='replace')})"
        )
    return flux, error, mask.astype(bool), z, flux_ok.astype(bool)

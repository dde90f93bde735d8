"""ctypes binding for the native (C++) token loader, the port's copy of
``kubeflow_tpu.train.native_loader``.

Worker threads and a bounded ring buffer produce int32 token batches —
synthetic (a deterministic splitmix64 stream) or random crops of a
memory-mapped binary token file — and ``dl_next`` copies straight into a
numpy buffer with the GIL released, so a training step never waits on
Python-side data generation.

The source, ``train/csrc/dataloader.cpp``, is byte for byte the JAX
package's ``native/dataloader.cpp``, so both loaders give the same
batches for the same seed, thread count and file. The shared library
builds on first use with g++ into the native cache (``KFTPU_NATIVE_CACHE``,
else ``~/.cache/kubeflow-tpu``; owned by this user and not group- or
world-writable, or it raises), keyed by the source's hash, through a
per-process temporary file replaced into place. Environments without a
toolchain raise ``NativeLoaderUnavailable``; the runner then falls back
to ``train.data.synthetic_text`` unless a corpus was asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger("native_loader")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "dataloader.cpp")
_BUILD_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeLoaderUnavailable(RuntimeError):
    pass


def _cache_dir(*subdirs: str) -> str:
    """The cache root for the built .so and validation markers
    (KFTPU_NATIVE_CACHE overrides; tests point it at a tmp root).

    The root is created 0700 and must be OWNED by this uid and not
    writable by group or others: the .so's name is predictable (a hash of
    public source), so a root another local user can write would let them
    plant a library this process then loads."""
    root = os.environ.get(
        "KFTPU_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "kubeflow-tpu"),
    )
    os.makedirs(root, mode=0o700, exist_ok=True)
    st = os.stat(root)
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        raise NativeLoaderUnavailable(
            f"native cache {root!r} is owned by uid {st.st_uid}, not "
            f"{os.getuid()}; refusing to load code from it "
            "(set KFTPU_NATIVE_CACHE to a directory you own)"
        )
    if st.st_mode & 0o022:
        # makedirs does not chmod a directory that exists already.
        raise NativeLoaderUnavailable(
            f"native cache {root!r} is group/world-writable "
            f"(mode {oct(st.st_mode & 0o777)}); refusing to load code "
            "from it; chmod 700 it or set KFTPU_NATIVE_CACHE"
        )
    d = os.path.join(root, *subdirs)
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str:
    if not os.path.exists(_SRC):
        raise NativeLoaderUnavailable(f"source missing: {_SRC}")
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"dataloader-{tag}.so")
    if os.path.exists(out):
        return out
    # Per-process temporary name: workers on one host race a cold cache;
    # os.replace of a complete file is atomic, a shared temporary is not.
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeLoaderUnavailable(f"g++ unavailable: {e}")
        if proc.returncode != 0:
            raise NativeLoaderUnavailable(f"build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    log.info("native loader built", kv={"lib": out})
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _BUILD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            lib.dl_create.restype = ctypes.c_void_p
            lib.dl_create.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int32,
            ]
            lib.dl_error.argtypes = [ctypes.c_void_p]
            lib.dl_error.restype = ctypes.c_int
            lib.dl_next.argtypes = [
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            lib.dl_next.restype = ctypes.c_int
            lib.dl_produced.argtypes = [ctypes.c_void_p]
            lib.dl_produced.restype = ctypes.c_uint64
            lib.dl_stalls.argtypes = [ctypes.c_void_p]
            lib.dl_stalls.restype = ctypes.c_uint64
            lib.dl_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


class NativeTokenLoader:
    """Batch iterator backed by the C++ ring buffer: each batch is
    ``{"inputs": int32 [batch_size, seq_len]}``.

    token_file: path to a raw little-endian int32 token dump (the
    tokenised-corpus format); empty means the synthetic stream."""

    def __init__(
        self,
        *,
        batch_size: int,
        seq_len: int,
        vocab_size: int = 32000,
        seed: int = 0,
        num_threads: int = 2,
        queue_depth: int = 4,
        token_file: str = "",
    ):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.token_file = token_file
        lib = _lib()
        self._lib = lib
        validate, marker = self._validation_marker(token_file, vocab_size)
        self._handle = lib.dl_create(
            batch_size, seq_len, vocab_size, seed, num_threads,
            queue_depth, token_file.encode(), 1 if validate else 0,
        )
        err = lib.dl_error(self._handle)
        if err:
            lib.dl_destroy(self._handle)
            self._handle = None
            raise NativeLoaderUnavailable(
                f"token file unusable (code {err}): {token_file!r}"
            )
        if validate and marker:
            with open(marker, "w") as f:
                f.write("ok\n")

    @staticmethod
    def _validation_marker(token_file: str, vocab_size: int):
        """Checking a corpus's vocabulary pages the whole file; the verdict
        is cached per (path, size, mtime, vocab), so one host checks once,
        not once per worker per restart. Returns (validate?, marker)."""
        if not token_file:
            return False, ""
        try:
            st = os.stat(token_file)
        except OSError:
            return True, ""           # the C side reports the open error
        key = hashlib.sha256(
            f"{os.path.realpath(token_file)}|{st.st_size}|{st.st_mtime_ns}"
            f"|{vocab_size}".encode()
        ).hexdigest()[:24]
        marker = os.path.join(_cache_dir("validated"), key)
        return (not os.path.exists(marker)), marker

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._handle is None:
            raise StopIteration  # closed; NULL into the C ABI segfaults
        out = np.empty((self.batch_size, self.seq_len), np.int32)
        if self._lib.dl_next(self._handle, out) != 0:
            raise StopIteration
        return {"inputs": out}

    @property
    def batches_produced(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.dl_produced(self._handle))

    @property
    def stalls(self) -> int:
        """Times a ``next()`` arrived before any batch was ready: the
        consumer outran the producers. A loader that keeps up with the
        train step holds this at ~0."""
        if self._handle is None:
            return 0
        return int(self._lib.dl_stalls(self._handle))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

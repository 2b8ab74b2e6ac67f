"""ctypes binding of the port's native ingest library, with plain numpy twins.

The port's own copy of motionstyle/native/ingest.py. window_normalize_collate
fuses the host-side batch assembly of the style datasets (window crop,
(x - mean) / std, zero-pad, the (T, C) -> (C, 1, T) transpose and the batch
stack; dataset.py:522-553 + tensors.py:90-97, as data/datasets.py and
data/collate.py implement them) into one multithreaded C++ pass.

Each function takes force_numpy=True for its numpy twin, the same math,
which the tests hold the library against. Without it the library is built
(native/build.py) and loaded at first use, and a library that does not build
or load raises RuntimeError with the reason: where the JAX package warns and
uses numpy, the port does not fall back quietly.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as np

_lock = threading.Lock()
_lib = None
_PF = ctypes.POINTER(ctypes.c_float)
_PI64 = ctypes.POINTER(ctypes.c_int64)


def load_library() -> ctypes.CDLL:
    """The built library with its argtypes set (built on first use, then
    cached for the process). Raises RuntimeError when it does not build or
    load."""
    global _lib
    with _lock:
        if _lib is None:
            from motionstyle_torch.native.build import build

            path, _, _ = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as ex:
                raise RuntimeError(f"loading the native ingest library {path} failed: {ex}") \
                    from ex
            lib.msn_window_normalize_collate.argtypes = [
                ctypes.POINTER(_PF), _PI64, _PI64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _PF, _PF, _PF, ctypes.c_int32]
            lib.msn_window_normalize_collate.restype = None
            lib.msn_lengths_to_mask.argtypes = [_PI64, ctypes.c_int64, ctypes.c_int64, _PF]
            lib.msn_lengths_to_mask.restype = None
            lib.msn_parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_int64, _PF,
                                             ctypes.c_int64]
            lib.msn_parse_floats.restype = ctypes.c_int64
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def _as_f32_c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def window_normalize_collate(motions: Sequence[np.ndarray], starts: Sequence[int],
                             m_lens: Sequence[int], max_len: int, mean: np.ndarray,
                             std: np.ndarray, nthreads: int = 0,
                             force_numpy: bool = False) -> np.ndarray:
    """motions: per-item (len_i, C) float arrays; crop [start, start + m_len),
    normalise, pad to max_len; returns (B, C, 1, max_len) float32.
    nthreads <= 0 takes the host's hardware thread count."""
    B = len(motions)
    mean = _as_f32_c(mean)
    C = mean.shape[0]
    inv_std = _as_f32_c(1.0 / np.asarray(std, np.float64))
    if force_numpy:
        out = np.zeros((B, C, max_len), np.float32)
        for b, (m, s, n) in enumerate(zip(motions, starts, m_lens)):
            win = np.asarray(m[s:s + n], np.float32)
            out[b, :, :n] = ((win - mean) * inv_std).T
        return out[:, :, None, :]
    lib = load_library()
    mats = [_as_f32_c(m) for m in motions]
    if not len(starts) == len(m_lens) == B:
        raise ValueError(f"{B} motions, {len(starts)} starts, {len(m_lens)} lengths")
    for m, s, n in zip(mats, starts, m_lens):  # the C++ pass trusts these bounds
        if m.ndim != 2 or m.shape[1] != C or not (0 <= s and 0 <= n <= max_len
                                                  and s + n <= m.shape[0]):
            raise ValueError(f"a window [{s}, {s} + {n}) of a {m.shape} motion does not fit "
                             f"(C={C}, max_len={max_len})")
    ptrs = (_PF * B)(*[m.ctypes.data_as(_PF) for m in mats])
    starts64 = np.ascontiguousarray(starts, np.int64)
    lens64 = np.ascontiguousarray(m_lens, np.int64)
    out = np.empty((B, C, 1, max_len), np.float32)
    lib.msn_window_normalize_collate(
        ptrs, starts64.ctypes.data_as(_PI64), lens64.ctypes.data_as(_PI64), B, C, max_len,
        mean.ctypes.data_as(_PF), inv_std.ctypes.data_as(_PF), out.ctypes.data_as(_PF),
        int(nthreads))
    return out


def parse_floats(text: str, force_numpy: bool = False) -> np.ndarray:
    """Whitespace-separated floats (BVH MOTION tables) in one strtof pass.
    The native pass STOPS at the first non-numeric byte, so a caller checks
    the returned count against the tokens it expects; the numpy twin
    (text.split()) raises instead."""
    if force_numpy:
        return np.array(text.split(), np.float32) if text.strip() else \
            np.empty((0,), np.float32)
    lib = load_library()
    raw = text.encode()
    cap = max(1, len(raw) // 2 + 1)  # a float needs >= 2 bytes with its separator
    out = np.empty((cap,), np.float32)
    n = lib.msn_parse_floats(raw, len(raw), out.ctypes.data_as(_PF), cap)
    return out[:n].copy()


def lengths_to_mask(lengths: Sequence[int], max_len: int,
                    force_numpy: bool = False) -> np.ndarray:
    """(B, 1, 1, T) float32 broadcast mask (collate.py:15 semantics)."""
    lens = np.ascontiguousarray(lengths, np.int64)
    if force_numpy:
        from motionstyle_torch.data.collate import lengths_to_mask as np_mask

        return np_mask(lens, max_len)[:, None, None, :]
    lib = load_library()
    out = np.empty((lens.shape[0], 1, 1, max_len), np.float32)
    lib.msn_lengths_to_mask(lens.ctypes.data_as(_PI64), lens.shape[0], max_len,
                            out.ctypes.data_as(_PF))
    return out

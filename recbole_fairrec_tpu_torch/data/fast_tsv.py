"""Atomic-file column readers: the native single-pass reader
(``native/fast_tsv.cpp``, loaded with ctypes) and a pure-Python parser with
the same output, used where the native library cannot be built.

Counterpart of ``recbole_fairrec_tpu/data/fast_tsv.py``. The shared library
is compiled with the system C++ compiler at first use into the package's
``_build/`` directory (git-ignored); the file name carries a hash of the
source, and the build writes a temporary file that is renamed into place,
so concurrent first uses from several processes are safe.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
from logging import getLogger

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "fast_tsv.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = None
_TRIED = False


def _build_library():
    if not os.path.isfile(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"fast_tsv-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for cxx in ("g++", "c++", "clang++"):
            try:
                subprocess.run(
                    [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, so_path)
            return so_path
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so_path = _build_library()
    if so_path is None:
        getLogger().debug("native fast_tsv unavailable; using the Python reader")
        return None
    lib = ctypes.CDLL(so_path)
    lib.tsv_open.restype = ctypes.c_void_p
    lib.tsv_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tsv_n_rows.restype = ctypes.c_longlong
    lib.tsv_n_rows.argtypes = [ctypes.c_void_p]
    lib.tsv_error.restype = ctypes.c_char_p
    lib.tsv_error.argtypes = [ctypes.c_void_p]
    lib.tsv_float_col.restype = ctypes.POINTER(ctypes.c_double)
    lib.tsv_float_col.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tsv_token_codes.restype = ctypes.POINTER(ctypes.c_int32)
    lib.tsv_token_codes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tsv_token_uniques.restype = ctypes.POINTER(ctypes.c_char)
    lib.tsv_token_uniques.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    ]
    lib.tsv_token_n_uniques.restype = ctypes.c_longlong
    lib.tsv_token_n_uniques.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tsv_close.restype = None
    lib.tsv_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def read_columns(filepath, sep, col_indices, col_is_token):
    """Parse the file in one native pass.

    Args:
        filepath: path to the headered TSV.
        sep: single-char field separator.
        col_indices: physical column numbers to extract.
        col_is_token: parallel bools — True → token column.

    Returns:
        list aligned with col_indices: float columns as float64 arrays (NaN
        where missing), token columns as object arrays of the original
        strings (None where missing). None when the native library is
        unavailable or parsing failed.
    """
    lib = _get_lib()
    if lib is None:
        return None
    n = len(col_indices)
    idx_arr = (ctypes.c_int * n)(*col_indices)
    tok_arr = (ctypes.c_int * n)(*[1 if t else 0 for t in col_is_token])
    handle = lib.tsv_open(filepath.encode(), sep.encode()[:1], idx_arr, tok_arr, n)
    try:
        err = lib.tsv_error(handle)
        if err:
            getLogger().debug("fast_tsv error for %s: %s", filepath, err.decode())
            return None
        rows = int(lib.tsv_n_rows(handle))
        out = []
        for slot, is_token in enumerate(col_is_token):
            if is_token:
                codes_ptr = lib.tsv_token_codes(handle, slot)
                codes = np.ctypeslib.as_array(codes_ptr, shape=(rows,)).copy() if rows else (
                    np.zeros(0, dtype=np.int32))
                total_len = ctypes.c_longlong()
                buf = lib.tsv_token_uniques(handle, slot, ctypes.byref(total_len))
                n_uniques = int(lib.tsv_token_n_uniques(handle, slot))
                raw = ctypes.string_at(buf, total_len.value).decode("utf-8")
                uniques = np.array(raw.split("\n") if n_uniques else [], dtype=object)
                values = np.empty(rows, dtype=object)
                valid = codes >= 0
                values[valid] = uniques[codes[valid]]
                values[~valid] = None
                out.append(values)
            else:
                ptr = lib.tsv_float_col(handle, slot)
                out.append(np.ctypeslib.as_array(ptr, shape=(rows,)).copy() if rows else (
                    np.zeros(0, dtype=np.float64)))
        return out
    finally:
        lib.tsv_close(handle)


def _parse_float(cell):
    if cell == "":
        return math.nan
    try:
        return float(cell)
    except ValueError:
        return math.nan


def read_columns_python(filepath, sep, col_indices, col_is_token, encoding="utf-8"):
    """Pure-Python reader with the native reader's contract: the header line
    is skipped, blank lines are skipped, a trailing ``\\r`` is dropped, a
    missing or empty cell is None (token) or NaN (float)."""
    cols = [[] for _ in col_indices]
    with open(filepath, "r", encoding=encoding, newline="") as f:
        f.readline()
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line == "":
                continue
            cells = line.split(sep)
            for slot, (c, is_token) in enumerate(zip(col_indices, col_is_token)):
                cell = cells[c] if c < len(cells) else ""
                if is_token:
                    cols[slot].append(cell if cell != "" else None)
                else:
                    cols[slot].append(_parse_float(cell))
    out = []
    for values, is_token in zip(cols, col_is_token):
        if is_token:
            arr = np.empty(len(values), dtype=object)
            arr[:] = values
            out.append(arr)
        else:
            out.append(np.asarray(values, dtype=np.float64))
    return out

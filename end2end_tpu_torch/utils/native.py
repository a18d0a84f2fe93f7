"""The C++ host runtime (`csrc/host/e2e_native.cpp`) through ctypes (torch
port of `end2end_tpu/utils/native.py`).

The library is built with g++ on first use into `csrc/build/`, named by a
hash of the source, the flags and the host's `-march=native` target, so
an edited source is rebuilt and a stale library never loaded.  It holds a
threaded prefix beam search (no LM, or a dense bigram fused as the device
decoders fuse it), a greedy decoder and the ARPA parsers: host code,
independent of the device decoders and of the Python parsers, which makes
it their oracle.  The functions take CPU tensors or numpy arrays and
return numpy arrays.

If g++ is missing or fails, a warning carries its error, `available()`
is False and the decoders raise; the ARPA parsers return None, and
`utils.arpa` then parses in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from .profiling import build_done

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "host" / "e2e_native.cpp"
BUILD_DIR = CSRC / "build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def build(build_dir=None) -> str | None:
    """Build the library into `build_dir` (default `csrc/build/`) unless a
    build of this source, these flags and this host's `-march=native`
    target is there; its path, or None with a warning when g++ is missing
    or fails."""
    t0 = time.perf_counter()
    gxx = shutil.which("g++")
    if gxx is None:
        warnings.warn("native build: g++ not found; the host runtime is "
                      "unavailable")
        return None
    # what -march=native resolves to: a checkout shared by two hosts
    # never loads the other's instructions
    target = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60).stdout
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + target
                            + SOURCE.read_bytes())
    out = Path(build_dir or BUILD_DIR) / (
        f"libe2e_native_{digest.hexdigest()[:16]}.so")
    cached = out.exists()
    if not cached:
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            so = str(Path(tmp, "lib.so"))
            proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", so],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                warnings.warn(f"native build failed ({proc.returncode}); "
                              f"the host runtime is unavailable:\n"
                              f"{proc.stderr.strip()}")
                return None
            os.replace(so, out)  # atomic: a concurrent build never sees half
    build_done(str(out), time.perf_counter() - t0, cached)
    return str(out)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.e2e_beam_search.argtypes = [
            c_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_i32p, c_i32p, c_f32p, ctypes.c_int,
        ]
        lib.e2e_beam_search_lm.argtypes = [
            c_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            c_f32p, c_f32p, ctypes.c_float, ctypes.c_float,
            c_i32p, c_i32p, c_f32p, ctypes.c_int,
        ]
        lib.e2e_greedy_decode.argtypes = [
            c_f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i32p,
            ctypes.c_int, c_i32p, c_i32p,
        ]
        lib.e2e_parse_arpa.restype = ctypes.c_long
        lib.e2e_parse_arpa.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            c_f32p, c_f32p, c_f32p, c_f32p,
        ]
        lib.e2e_arpa_scan.restype = ctypes.c_int
        lib.e2e_arpa_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long), c_f32p,
        ]
        lib.e2e_arpa_dump.restype = ctypes.c_long
        lib.e2e_arpa_dump.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            c_i32p, c_f32p, c_f32p, ctypes.c_long,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _host(x, dtype):
    """A tensor (copied to the host) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (g++ build failed?)")
    return lib


def beam_search_cpu(log_probs, input_lengths, beam_width=8, prune_k=None,
                    blank=0, max_symbols=None, n_threads=0,
                    lm_table=None, lm_eos=None, lm_alpha=0.0, lm_beta=0.0):
    """Threaded native prefix beam search on the host.

    log_probs: (T, N, V) float.  Returns (tokens (N, W, s_cap), lengths
    (N, W), scores (N, W)).  Raises if the native library is unavailable.

    Optional dense-bigram shallow fusion: lm_table (V+1, V) log p(next |
    prev) with row V the start context (`ops.lm.NGramLM._table`'s layout),
    lm_eos (V,) end scores; the device decoders' semantics.
    """
    lib = _lib()
    lp = np.ascontiguousarray(np.moveaxis(_host(log_probs, np.float32), 1, 0))
    n, t_max, v = lp.shape
    il = np.ascontiguousarray(_host(input_lengths, np.int32))
    k = min(prune_k or v, v)
    s_cap = max_symbols or min(t_max, 512)
    tokens = np.empty((n, beam_width, s_cap), np.int32)
    lens = np.empty((n, beam_width), np.int32)
    scores = np.empty((n, beam_width), np.float32)
    if lm_table is None:
        lib.e2e_beam_search(_f32p(lp), n, t_max, v, _i32p(il), beam_width, k,
                            blank, s_cap, _i32p(tokens), _i32p(lens),
                            _f32p(scores), n_threads)
    else:
        lm_t = np.ascontiguousarray(_host(lm_table, np.float32))
        if lm_t.shape != (v + 1, v):
            raise ValueError(f"lm_table must be (V+1, V)=({v + 1}, {v}), "
                             f"got {lm_t.shape}")
        lm_e = np.ascontiguousarray(
            _host(lm_eos, np.float32) if lm_eos is not None
            else np.zeros((v,), np.float32))
        if lm_e.shape != (v,):
            raise ValueError(f"lm_eos must be (V,)=({v},), got {lm_e.shape}")
        lib.e2e_beam_search_lm(
            _f32p(lp), n, t_max, v, _i32p(il), beam_width, k, blank, s_cap,
            _f32p(lm_t), _f32p(lm_e), ctypes.c_float(lm_alpha),
            ctypes.c_float(lm_beta), _i32p(tokens), _i32p(lens),
            _f32p(scores), n_threads,
        )
    return tokens, lens, scores


def greedy_decode_cpu(log_probs, input_lengths, blank=0):
    """Native greedy decode; returns (tokens (N, T), lengths (N,))."""
    lib = _lib()
    lp = np.ascontiguousarray(np.moveaxis(_host(log_probs, np.float32), 1, 0))
    n, t_max, v = lp.shape
    il = np.ascontiguousarray(_host(input_lengths, np.int32))
    tokens = np.empty((n, t_max), np.int32)
    lens = np.empty((n,), np.int32)
    lib.e2e_greedy_decode(_f32p(lp), n, t_max, v, _i32p(il), blank,
                          _i32p(tokens), _i32p(lens))
    return tokens, lens


def parse_arpa_native(path: str, vocab: list[str]):
    """An ARPA file's dense bigram tables via the native parser: (unigram
    (V,), bigram (V, V), start (V,), eos (V,)) natural-log float32 arrays,
    as `utils.arpa.parse_arpa_python` gives them, or None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = len(vocab)
    blob = b"\0".join(w.encode() for w in vocab) + b"\0"
    unigram = np.empty((v,), np.float32)
    bigram = np.empty((v, v), np.float32)
    start = np.empty((v,), np.float32)
    eos = np.empty((v,), np.float32)
    n = lib.e2e_parse_arpa(path.encode(), blob, v, _f32p(unigram),
                           _f32p(bigram), _f32p(start), _f32p(eos))
    if n < 0:
        raise FileNotFoundError(path)
    return unigram, bigram, start, eos


def parse_arpa_order_native(path: str, vocab: list[str]):
    """An ARPA file of any order via the native parser, as
    `utils.arpa.parse_arpa_order` gives it; None if the library is
    missing or the order is above 8 (the C parser's limit)."""
    lib = _load()
    if lib is None:
        return None
    v = len(vocab)
    blob = b"\0".join(w.encode() for w in vocab) + b"\0"
    counts = (ctypes.c_long * 9)()
    unk = np.array([np.nan], np.float32)
    order = lib.e2e_arpa_scan(path.encode(), blob, v, counts, _f32p(unk))
    if order == -2:
        return None
    if order < 0:
        raise FileNotFoundError(path)
    ngrams: dict = {"unk": None if np.isnan(unk[0]) else float(unk[0])}
    for k in range(1, order + 1):
        cap = max(int(counts[k]), 1)
        ids = np.empty((cap, k), np.int32)
        lp = np.empty((cap,), np.float32)
        bo = np.empty((cap,), np.float32)
        n = lib.e2e_arpa_dump(path.encode(), blob, v, k, _i32p(ids),
                              _f32p(lp), _f32p(bo), cap)
        ngrams[k] = [
            (tuple(int(x) for x in ids[i]), float(lp[i]), float(bo[i]))
            for i in range(n)
        ]
    return order, ngrams

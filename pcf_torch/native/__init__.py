"""ctypes bindings for the native host-preprocessing library: voxel-barycenter
grid subsampling and KD-tree kNN (pcf_native.cpp, the same source as
pcf_tpu/native), with the contracts of pcf_tpu/native/__init__.py.

The library is built with g++ at first use into pcf_torch/_build/, never into
the source directory. Its file name carries a hash of the source, the flags
and the target that g++ resolves -march=native to on this host, so an edited
source is rebuilt, and so is a build directory copied to a host of another
CPU. Where g++ is missing, is_available() is False and the pipeline takes its
numpy/scipy path (data/pyramid.py); a build that fails raises. Nothing is
built when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("pcf_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")
_LOCK = threading.Lock()  # the loader's worker threads may ask first


def library_path(cxx: str) -> Path:
    """Where the library built by `cxx` from SOURCE with FLAGS lives."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(target.encode())
    return BUILD_DIR / f"libpcf_native-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None where g++ is missing."""
    with _LOCK:
        return _build_and_load()


@functools.cache
def _build_and_load() -> ctypes.CDLL | None:
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    so = library_path(cxx)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        r = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} (exit {r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(so))
    f32, i32, i64 = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                     ctypes.POINTER(ctypes.c_int64))
    lib.grid_subsample.restype = ctypes.c_int32
    lib.grid_subsample.argtypes = [f32, ctypes.c_int64, f32, ctypes.c_int32, i32,
                                   ctypes.c_int32, ctypes.c_float, f32, f32, i32]
    lib.knn_kdtree.restype = None
    lib.knn_kdtree.argtypes = [f32, ctypes.c_int64, f32, ctypes.c_int64, ctypes.c_int32,
                               i32]
    lib.knn_kdtree_batch.restype = None
    lib.knn_kdtree_batch.argtypes = [f32, i64, f32, i64, ctypes.c_int32, ctypes.c_int32,
                                     i32]
    return lib


def is_available() -> bool:
    """Whether the library is (or can be) built here: g++ exists."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library needs g++, which was not found")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def grid_subsample(points: np.ndarray, features: np.ndarray | None = None,
                   labels: np.ndarray | None = None, sample_dl: float = 0.1):
    """Voxel-barycenter subsampling with the contract of
    ops.subsample.grid_subsampling (the same voxels, in another order)."""
    lib = _lib()
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    out_pts = np.empty((n, 3), np.float32)
    f_dim = 0
    f_in = f_out = l_in = l_out = None
    if features is not None:
        f_in = np.ascontiguousarray(features, np.float32)
        f_dim = f_in.shape[1]
        f_out = np.empty((n, f_dim), np.float32)
    if labels is not None:
        l_in = np.ascontiguousarray(labels, np.int32).reshape(-1)
        l_out = np.empty(n, np.int32)
    n_vox = lib.grid_subsample(
        _fptr(points), n, None if f_in is None else _fptr(f_in), f_dim,
        None if l_in is None else _i32ptr(l_in), 0, float(sample_dl), _fptr(out_pts),
        None if f_out is None else _fptr(f_out), None if l_out is None else _i32ptr(l_out))
    out = [out_pts[:n_vox].copy()]
    if f_out is not None:
        out.append(f_out[:n_vox].copy())
    if l_out is not None:
        out.append(l_out[:n_vox].copy())
    return out[0] if len(out) == 1 else tuple(out)


def knn(ref_points: np.ndarray, query_points: np.ndarray, k: int) -> np.ndarray:
    """KD-tree kNN: indices [n_query, k] int32, ascending by distance."""
    lib = _lib()
    ref = np.ascontiguousarray(ref_points, np.float32)
    q = np.ascontiguousarray(query_points, np.float32)
    out = np.empty((q.shape[0], k), np.int32)
    lib.knn_kdtree(_fptr(ref), ref.shape[0], _fptr(q), q.shape[0], k, _i32ptr(out))
    return out


def knn_batch(queries: np.ndarray, refs: np.ndarray, q_lens, r_lens, k: int) -> np.ndarray:
    """Batched packed kNN: each cloud's queries against its own refs, indices
    into the packed refs (the contract of cpp_neighbors batch_kquery)."""
    lib = _lib()
    refs = np.ascontiguousarray(refs, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    q_lens = np.ascontiguousarray(q_lens, np.int64)
    r_lens = np.ascontiguousarray(r_lens, np.int64)
    if q_lens.sum() != queries.shape[0] or r_lens.sum() != refs.shape[0] \
            or len(q_lens) != len(r_lens):
        raise ValueError(f"knn_batch: lengths {q_lens.tolist()} / {r_lens.tolist()} do not "
                         f"cover {queries.shape[0]} queries / {refs.shape[0]} refs")
    out = np.empty((queries.shape[0], k), np.int32)
    lib.knn_kdtree_batch(_fptr(refs), _i64ptr(r_lens), _fptr(queries), _i64ptr(q_lens),
                         len(q_lens), k, _i32ptr(out))
    return out

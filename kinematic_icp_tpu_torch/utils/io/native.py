"""ctypes bindings for the native ingestion library (``libkicp_io``), and
the host build of the repository's native C++ sources.

The native host-side hot loops of the ingestion layer (PointCloud2 field
extraction, LaserScan projection; the reference's RosUtils/
TimeStampHandler C++ equivalents) are ``native/kicp_io.cpp``, which the
JAX package also calls.  This module compiles it with ``g++`` and the flags
of ``native/Makefile`` into ``_build/`` inside this package (listed in
``.gitignore``), never into ``native/``: the file name carries a hash of
the source and the flags, so an edited source is rebuilt.  Every caller
keeps a numpy fallback for hosts without a compiler (the reference's
semantics); ``get_lib()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

log = logging.getLogger("kinematic_icp_tpu_torch.native")

_PKG = Path(__file__).resolve().parents[2]
#: the repository's native sources (read, never written)
NATIVE_SRC = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
#: native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-Wextra")
#: target -> (source, output prefix, extra flags, suffix), as
#: native/Makefile builds them
TARGETS = {
    "kicp_io": ("kicp_io.cpp", "libkicp_io", ("-shared",), ".so"),
    "kicp_baseline": ("kicp_baseline.cpp", "kicp_baseline", ("-pthread",),
                      ""),
}

_lib = None
_lib_attempted = False

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def artifact_path(target: str) -> Path:
    """Where ``build(target)`` puts its output: ``_build/<name>-<hash>``."""
    src, prefix, extra, suffix = TARGETS[target]
    data = (NATIVE_SRC / src).read_bytes()
    digest = hashlib.sha256(
        data + " ".join(CXXFLAGS + extra).encode()).hexdigest()
    return BUILD_DIR / f"{prefix}-{digest[:16]}{suffix}"


def build(*targets: str) -> dict[str, dict]:
    """Compile the named targets, one ``g++`` each, all started together.

    Returns ``{target: {"path", "seconds"}}``; raises if ``g++`` is missing
    or any build fails.
    """
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for target in targets:
        src, _, extra, _ = TARGETS[target]
        out = artifact_path(target)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXXFLAGS, *extra, "-o", str(tmp), str(NATIVE_SRC / src)]
        jobs[target] = (out, tmp, time.perf_counter(),
                        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    results, failed = {}, []
    for target, (out, tmp, t0, proc) in jobs.items():
        msgs, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{target}: g++ exited {proc.returncode}\n{msgs}")
            continue
        os.replace(tmp, out)  # atomic against a concurrent build
        results[target] = {"path": str(out),
                           "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return results


def built(target: str) -> Path:
    """The target's output, built first if missing (raises if it cannot
    be built)."""
    path = artifact_path(target)
    if not path.exists():
        build(target)
    return path


def get_lib():
    """The loaded library, or None where it cannot be built or loaded
    (the numpy fallbacks run then)."""
    global _lib, _lib_attempted
    if _lib is not None or _lib_attempted:
        return _lib
    _lib_attempted = True
    try:
        path = built("kicp_io")
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:  # no compiler, or a failed build
        log.warning("native ingestion library unavailable: %s", e)
        return None
    lib.kicp_extract_pointcloud.restype = ctypes.c_int64
    lib.kicp_extract_pointcloud.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        _f32p, _f32p, _f32p, _f64p]
    lib.kicp_project_laserscan.restype = ctypes.c_int64
    lib.kicp_project_laserscan.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _f32p, _f32p, _f32p]
    _lib = lib
    return _lib


def _ptr(arr, typ):
    return arr.ctypes.data_as(typ)


def extract_pointcloud(data: bytes | memoryview, n_points: int,
                       point_step: int, x_offset: int, y_offset: int,
                       z_offset: int, xyz_dtype: int, t_offset: int = -1,
                       t_dtype: int = 0):
    """Native field extraction; returns (xyz (N,3) f32, t (N,) f64 or None).

    ``data`` is bytes-like (bytes or a ``memoryview``, read in place, never
    written).

    Returns None if the native library is unavailable (caller falls back).
    """
    lib = get_lib()
    if lib is None:
        return None
    if len(data) < n_points * point_step:
        raise ValueError(f"PointCloud2 data holds {len(data)} bytes, fewer "
                         f"than {n_points} points of {point_step}")
    raw = np.frombuffer(data, dtype=np.uint8)
    x = np.empty(n_points, np.float32)
    y = np.empty(n_points, np.float32)
    z = np.empty(n_points, np.float32)
    t = np.empty(n_points, np.float64) if t_offset >= 0 else np.empty(0)
    lib.kicp_extract_pointcloud(
        _ptr(raw, _u8p), n_points, point_step, x_offset, y_offset, z_offset,
        xyz_dtype, t_offset, t_dtype,
        _ptr(x, _f32p), _ptr(y, _f32p), _ptr(z, _f32p), _ptr(t, _f64p))
    xyz = np.stack([x, y, z], axis=-1)
    return xyz, (t if t_offset >= 0 else None)


def project_laserscan(ranges, angle_min: float, angle_increment: float,
                      time_increment: float, range_min: float,
                      range_max: float):
    """Native LaserScan projection; returns (x, y, t) planes or None."""
    lib = get_lib()
    if lib is None:
        return None
    r = np.ascontiguousarray(ranges, np.float32)
    n = len(r)
    x = np.empty(n, np.float32)
    y = np.empty(n, np.float32)
    t = np.empty(n, np.float32)
    m = lib.kicp_project_laserscan(
        _ptr(r, _f32p), n, angle_min, angle_increment, time_increment,
        range_min, range_max, _ptr(x, _f32p), _ptr(y, _f32p), _ptr(t, _f32p))
    return x[:m], y[:m], t[:m]

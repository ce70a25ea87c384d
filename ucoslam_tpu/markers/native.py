"""ctypes binding for the native C++ ArUco detector (native/aruco_detector.cpp).

Builds the shared library on first use if the toolchain is available
(`build`); the cv2-backed detector remains as fallback. The native path removes the OpenCV
dependency from marker detection, mirroring the reference's vendored C++
aruco (3rdparty/aruco).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
#: built from the tracked sources into the git-ignored build/ tree, so a
#: library compiled on another machine is never picked up from a checkout
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libaruco_native.so")

_lib = None


def build(force: bool = False) -> str:
    """Compile native/aruco_detector.cpp into build/native/ with make.

    force=True rebuilds even when the library exists (a checkout copied
    from another machine must not reuse its binary). Raises on failure.
    """
    global _lib
    if force:
        _lib = None
    if os.path.exists(_LIB_PATH) and not force:
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build under a private name and rename: concurrent test workers may
    # build at once, and none may load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["make", "-B", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        build()
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.aruco_detect.restype = ctypes.c_int
    lib.aruco_detect.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def detect_markers_native(
    gray: np.ndarray,
    max_out: int = 32,
    min_perimeter: int = 40,
    max_correction: int = 1,
    dictionary: str = "ARUCO_MIP_36h12",
):
    """-> (ids (n,), corners (n, 4, 2) float32).

    The C ABI is dictionary-agnostic (codewords + bits-per-side are
    arguments); ARUCO_MIP_36h12 uses the library's builtin table, other
    dictionaries are loaded from the native/ codeword headers
    (markers.dictionary) and passed in.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native aruco library unavailable")
    img = np.ascontiguousarray(np.clip(gray, 0, 255), np.uint8)
    h, w = img.shape
    corners = np.zeros((max_out, 4, 2), np.float32)
    ids = np.zeros(max_out, np.int32)
    if dictionary == "ARUCO_MIP_36h12":
        dict_ptr, dict_size, nbits = None, 0, 0
    else:
        from ucoslam_tpu.markers.dictionary import dict_bits, load_codewords

        words = np.ascontiguousarray(load_codewords(dictionary), np.uint64)
        dict_ptr = words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        dict_size, nbits = len(words), dict_bits(dictionary)
    n = lib.aruco_detect(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        dict_ptr, dict_size, nbits, min_perimeter, max_correction,
        corners.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
    )
    return ids[:n].copy(), corners[:n].copy()

# JPEG codec utilities, a copy of `lfdtpu/data/jpeg.py` (stand-in for the
# reference's vendored libturbojpeg ctypes wrapper,
# `lfd/data_pipeline/dataset/utils/turbojpeg.py`).
#
# Same surface: `decode(bytes) -> BGR/gray ndarray` (`turbojpeg.py:249-279`),
# `encode(ndarray, quality) -> bytes` (`:281-299`), `scale_with_quality
# (bytes, scaling_factor, quality) -> bytes` (`:301-331`) and `crop(bytes,
# x, y, w, h) -> bytes` (`:333-368`). Each tries libturbojpeg via ctypes
# when present, else cv2 with equivalent observable behavior (crop is
# MCU-aligned like the original but re-encodes rather than transforming
# losslessly). With neither, they raise, naming both. cv2 is imported only
# when it is used.

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_TJPF_BGR = 1
_TJPF_GRAY = 6
_TJ = None
_TJ_HANDLE = None


def _init_turbojpeg():
    global _TJ, _TJ_HANDLE
    if _TJ is not None:
        return _TJ_HANDLE is not None
    path = ctypes.util.find_library("turbojpeg")
    if path is None:
        _TJ = False
        return False
    try:
        lib = ctypes.CDLL(path)
        lib.tjInitDecompress.restype = ctypes.c_void_p
        lib.tjDecompressHeader3.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_ulong,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.tjDecompress2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_ulong,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.tjInitCompress.restype = ctypes.c_void_p
        lib.tjCompress2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.tjFree.argtypes = [ctypes.c_void_p]
        lib.tjDestroy.argtypes = [ctypes.c_void_p]
        _TJ = lib
        _TJ_HANDLE = lib.tjInitDecompress()
        return True
    except Exception:
        _TJ = False
        return False


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "JPEG coding needs libturbojpeg (ctypes found no usable library) "
            "or OpenCV (cv2 does not import)") from e
    return cv2


def decode(image_bytes: bytes) -> np.ndarray:
    """Decode JPEG bytes to BGR uint8 HWC (gray images stay 2-D),
    mirroring turbojpeg.decode's autodetect (`turbojpeg.py:249-279`)."""
    if _init_turbojpeg():
        buf = np.frombuffer(image_bytes, dtype=np.uint8)
        src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        w = ctypes.c_int()
        h = ctypes.c_int()
        subsamp = ctypes.c_int()
        colorspace = ctypes.c_int()
        ret = _TJ.tjDecompressHeader3(
            _TJ_HANDLE, src, len(image_bytes),
            ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(subsamp), ctypes.byref(colorspace),
        )
        if ret == 0:
            gray = subsamp.value == 3  # TJSAMP_GRAY
            ch = 1 if gray else 3
            out = np.empty((h.value, w.value, ch), dtype=np.uint8)
            dst = out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            fmt = _TJPF_GRAY if gray else _TJPF_BGR
            if _TJ.tjDecompress2(_TJ_HANDLE, src, len(image_bytes), dst,
                                 w.value, 0, h.value, fmt, 0) == 0:
                return out[:, :, 0] if gray else out
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(image_bytes, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError("failed to decode image bytes")
    return img


_TJSAMP_422 = 1
_TJ_MCU = 16  # worst-case MCU block (4:2:0/4:2:2 chroma)


def encode(img_array: np.ndarray, quality: int = 85) -> bytes:
    """BGR (or gray) ndarray -> JPEG bytes (`turbojpeg.py:281-299`)."""
    img = np.ascontiguousarray(img_array)
    if img.ndim == 3 and _init_turbojpeg():
        handle = _TJ.tjInitCompress()
        try:
            h, w = img.shape[:2]
            src = img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            buf = ctypes.c_void_p()
            size = ctypes.c_ulong()
            status = _TJ.tjCompress2(
                handle, src, w, img.strides[0], h, _TJPF_BGR,
                ctypes.byref(buf), ctypes.byref(size), _TJSAMP_422,
                int(quality), 0,
            )
            if status == 0:
                out = ctypes.string_at(buf.value, size.value)
                _TJ.tjFree(buf)
                return out
            _TJ.tjFree(buf)
        finally:
            _TJ.tjDestroy(handle)
    cv2 = _cv2()
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        raise ValueError("failed to encode image")
    return enc.tobytes()


def scale_with_quality(jpeg_buf: bytes, scaling_factor=None, quality: int = 85) -> bytes:
    """Rescale a JPEG by num/denom and re-encode at `quality`
    (`turbojpeg.py:301-331`). Supported factors match turbojpeg's
    (n/8 for n in 1..16); dims round up like tjGetScaledValue."""
    factors = {(n, 8) for n in range(1, 17)} | {(1, 1), (1, 2), (1, 4), (3, 4)}
    if scaling_factor is not None and tuple(scaling_factor) not in factors:
        raise ValueError(f"unsupported scaling factor {scaling_factor}")
    img = decode(jpeg_buf)
    if scaling_factor is not None and tuple(scaling_factor) != (1, 1):
        num, denom = scaling_factor
        h, w = img.shape[:2]
        nh = (h * num + denom - 1) // denom
        nw = (w * num + denom - 1) // denom
        cv2 = _cv2()
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
    return encode(img, quality=quality)


def crop(jpeg_buf: bytes, x: int, y: int, w: int, h: int, gray: bool = False) -> bytes:
    """MCU-aligned JPEG crop (`turbojpeg.py:333-368`): x/y snap DOWN to the
    MCU grid and the region extends by the snap amount, clipped to the
    image — the same boundary rule as tjTransform's TJXOPT_CROP. (The
    libturbojpeg original is lossless in the DCT domain; this re-encodes.)"""
    img = decode(jpeg_buf)
    ih, iw = img.shape[:2]

    def bounds(a, b, limit):
        img_b = limit - (limit % _TJ_MCU)
        a = min(a, img_b)
        delta = a % _TJ_MCU
        a -= delta
        b += delta
        b = min(b, limit - a)
        return a, b

    x, w = bounds(int(x), int(w), iw)
    y, h = bounds(int(y), int(h), ih)
    out = img[y : y + h, x : x + w]
    if gray and out.ndim == 3:
        cv2 = _cv2()
        out = cv2.cvtColor(out, cv2.COLOR_BGR2GRAY)
    return encode(out, quality=95)

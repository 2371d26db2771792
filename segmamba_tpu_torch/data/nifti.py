"""Minimal native NIfTI-1 reader/writer (pure numpy + gzip).

A copy of ``segmamba_tpu/data/nifti.py``, kept in the port because the port
imports nothing of the JAX package.

The reference reads/writes volumes through SimpleITK
(the reference SegMamba's light_training/preprocessing/preprocessors/
preprocessor_mri.py:64,
light_training/prediction.py:208-226); that library isn't available here, and
the format is simple enough to own. Conventions match SimpleITK's so the rest
of the pipeline is drop-in:

- arrays are returned index-ordered ``(z, y, x)`` (SimpleITK
  ``GetArrayFromImage`` order),
- ``spacing`` is ``(x, y, z)`` voxel size (SimpleITK ``GetSpacing`` order) —
  the preprocessor reverses it for shape math exactly like the reference does
  (default_preprocessor.py:160-162).

Supports the common scalar dtypes, scl_slope/inter scaling, .nii and .nii.gz.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HDR_SIZE = 348


@dataclass
class NiftiImage:
    array: np.ndarray            # (z, y, x)
    spacing: tuple = (1.0, 1.0, 1.0)  # (x, y, z)
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))


def _open(path, mode="rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path, with_meta: bool = False):
    """Read a .nii / .nii.gz volume -> (z, y, x) ndarray (or NiftiImage)."""
    with _open(path) as f:
        raw = f.read()
    hdr = raw[:_HDR_SIZE]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        # big-endian writer: sizeof_hdr byte-swapped
        (sizeof_hdr_be,) = struct.unpack_from(">i", hdr, 0)
        if sizeof_hdr_be == _HDR_SIZE:
            endian = ">"
        else:
            raise ValueError(f"{path}: not a NIfTI-1 file "
                             f"(sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(max(1, d) for d in dim[1:1 + max(ndim, 3)])
    (datatype,) = struct.unpack_from(endian + "h", hdr, 70)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", hdr, 112)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=int(vox_offset)).astype(
        np.dtype(_DTYPES[datatype]))
    # on-disk order is Fortran (x fastest)
    arr = data.reshape(shape, order="F")
    # collapse trailing singleton dims beyond 3
    while arr.ndim > 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        arr = arr * slope + scl_inter
    if arr.ndim == 3:
        arr = arr.transpose(2, 1, 0)  # (x,y,z) -> (z,y,x)
    spacing = tuple(float(p) for p in pixdim[1:4])

    srow = np.zeros((4, 4), np.float64)
    srow[0] = struct.unpack_from(endian + "4f", hdr, 280)
    srow[1] = struct.unpack_from(endian + "4f", hdr, 296)
    srow[2] = struct.unpack_from(endian + "4f", hdr, 312)
    srow[3, 3] = 1.0
    (sform_code,) = struct.unpack_from(endian + "h", hdr, 254)
    if sform_code <= 0:
        srow = np.diag([spacing[0], spacing[1], spacing[2], 1.0])
    if with_meta:
        return NiftiImage(array=arr, spacing=spacing, affine=srow)
    return arr


def write_nifti(path, array, spacing=(1.0, 1.0, 1.0), affine=None):
    """Write a (z, y, x) volume to .nii / .nii.gz."""
    arr = np.asarray(array)
    if arr.ndim != 3:
        raise ValueError("write_nifti expects a 3-D (z, y, x) array")
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    code = _DTYPE_CODES[arr.dtype]
    disk = arr.transpose(2, 1, 0)  # back to (x, y, z)
    shape = disk.shape

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, shape[0], shape[1], shape[2],
                     1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    if affine is None:
        affine = np.diag([spacing[0], spacing[1], spacing[2], 1.0])
    struct.pack_into("<2h", hdr, 252, 0, 1)   # qform=0, sform=1
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"                 # magic at 344..347
    hdr_bytes = bytes(hdr) + b"\x00\x00\x00\x00"  # 4 extension bytes -> 352

    with _open(path, "wb") as f:
        f.write(hdr_bytes)
        f.write(disk.tobytes(order="F"))

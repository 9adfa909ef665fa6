"""NIfTI-1 read/write in pure Python (numpy only).

The port's own copy of ``multimodal_survival_prediction_tpu/data/nifti.py``
(its C++ fast reader is ``data/native.py``). One difference: a big-endian file
yields a NATIVE-byte-order array here, because ``torch.from_numpy`` refuses
non-native arrays and every volume this module reads goes to torch next.

Array axis convention: arrays come back in (D, H, W) = (k, j, i) order —
what ``sitk.GetArrayFromImage`` gives the reference's datasets (z, y, x),
i.e. the transpose of the on-disk Fortran (i fastest) layout.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HDR_SIZE = 348


@dataclass
class NiftiImage:
    """Voxels + the geometry metadata the pipeline records."""

    data: np.ndarray  # (D, H, W)
    spacing: tuple = (1.0, 1.0, 1.0)  # (x, y, z) voxel size
    origin: tuple = (0.0, 0.0, 0.0)
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def shape(self):
        return self.data.shape


def _open_maybe_gzip(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path) -> NiftiImage:
    """Read a .nii / .nii.gz file -> NiftiImage with a (D,H,W) array in
    native byte order (scl_slope/scl_inter applied when meaningful)."""
    path = Path(path)
    with _open_maybe_gzip(path, "rb") as f:
        raw = f.read()

    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr_be,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr_be != _HDR_SIZE:
            raise ValueError(f"not a NIfTI-1 file: {path}")
        endian = ">"
    else:
        endian = "<"

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = dim[0]
    shape_xyz = tuple(int(d) for d in dim[1 : 1 + max(ndim, 3)])[:3]
    (datatype,) = struct.unpack_from(endian + "h", raw, 70)
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", raw, 112)
    qoffset = struct.unpack_from(endian + "3f", raw, 268)
    srow = np.array(struct.unpack_from(endian + "12f", raw, 280)).reshape(3, 4)
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic {magic!r} in {path}")

    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype} in {path}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    nvox = int(np.prod(shape_xyz))
    arr = np.frombuffer(raw, dtype=np_dtype, count=nvox, offset=int(vox_offset))
    # on-disk order is Fortran over (x,y,z); reshape to (x,y,z) then -> (z,y,x)
    arr = arr.reshape(shape_xyz, order="F").transpose(2, 1, 0)

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr.astype(np.float32) * slope + scl_inter
    else:
        # one copy: native byte order, C-contiguous, writable (the view of
        # the file's bytes is read-only, which torch.from_numpy warns about)
        arr = np.array(arr, dtype=arr.dtype.newbyteorder("="), order="C")

    affine = np.eye(4)
    if np.any(srow):
        affine[:3, :4] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1:4]
        affine[:3, 3] = qoffset

    return NiftiImage(
        data=arr,
        spacing=tuple(float(p) for p in pixdim[1:4]),
        origin=tuple(float(q) for q in qoffset),
        affine=affine,
    )


def write_nifti(path, data: np.ndarray, spacing=(1.0, 1.0, 1.0),
                origin=(0.0, 0.0, 0.0)) -> None:
    """Write a (D,H,W) array as .nii or .nii.gz (NIfTI-1, single file,
    little-endian)."""
    path = Path(path)
    data = np.asarray(data)
    data = data.astype(data.dtype.newbyteorder("<"), copy=False)
    if data.dtype.newbyteorder("=") not in _DTYPE_CODES:
        data = data.astype("<f4")
    dz, dy, dx = data.shape
    shape_xyz = (dx, dy, dz)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, *shape_xyz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype.newbyteorder("=")])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl slope/inter
    # sform: diagonal spacing + origin (code 1)
    struct.pack_into("<h", hdr, 252, 1)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<3f", hdr, 268, *origin)
    srow = np.zeros((3, 4), np.float32)
    srow[0, 0], srow[1, 1], srow[2, 2] = spacing
    srow[:, 3] = origin
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(
        data.transpose(2, 1, 0)).tobytes(order="F")
    with _open_maybe_gzip(path, "wb") as f:
        f.write(payload)

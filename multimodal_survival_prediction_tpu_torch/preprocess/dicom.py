"""Minimal DICOM reader + series-to-volume assembly (numpy + struct): the
port's copy of ``multimodal_survival_prediction_tpu/preprocess/dicom.py``.

The reference delegates DICOM decoding to SimpleITK/GDCM (reference
convert_dicom_to_nifti.py:57-64). This module implements the needed subset
of DICOM Part 10 directly: explicit/implicit VR little endian, uncompressed
pixel data, sequence skipping, and the geometry/metadata tags the pipeline
records (reference convert_dicom_to_nifti.py:83-91). Compressed transfer
syntaxes raise (they would need a codec).

Series assembly: slices sorted by the projection of ImagePositionPatient on
the slice normal (fallback: InstanceNumber), stacked to (D, H, W) with
rescale slope/intercept applied — matching how ITK builds the volume the
reference's datasets consume.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# tag constants (group, element)
TRANSFER_SYNTAX = (0x0002, 0x0010)
MODALITY = (0x0008, 0x0060)
STUDY_DATE = (0x0008, 0x0020)
MANUFACTURER = (0x0008, 0x0070)
MODEL_NAME = (0x0008, 0x1090)
SERIES_DESC = (0x0008, 0x103E)
SERIES_UID = (0x0020, 0x000E)
INSTANCE_NUMBER = (0x0020, 0x0013)
IMAGE_POSITION = (0x0020, 0x0032)
IMAGE_ORIENTATION = (0x0020, 0x0037)
SLICE_THICKNESS = (0x0018, 0x0050)
PIXEL_SPACING = (0x0028, 0x0030)
ROWS = (0x0028, 0x0010)
COLS = (0x0028, 0x0011)
BITS_ALLOCATED = (0x0028, 0x0100)
PIXEL_REPRESENTATION = (0x0028, 0x0103)
RESCALE_INTERCEPT = (0x0028, 0x1052)
RESCALE_SLOPE = (0x0028, 0x1053)
PIXEL_DATA = (0x7FE0, 0x0010)

EXPLICIT_LE = "1.2.840.10008.1.2.1"
IMPLICIT_LE = "1.2.840.10008.1.2"

_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT",
             b"UN"}
_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIM = (0xFFFE, 0xE00D)
_SEQ_DELIM = (0xFFFE, 0xE0DD)


@dataclass
class DicomSlice:
    tags: dict
    pixels: np.ndarray  # (rows, cols), rescaled to HU-ish float32

    def tag(self, key, default=None):
        return self.tags.get(key, default)


def _parse_elements(buf: bytes, offset: int, explicit: bool, stop_at_pixels):
    """Yield (tag, value_bytes) until end of buffer."""
    tags = {}
    pixel_data = None
    n = len(buf)
    pos = offset
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        pos += 4
        if tag in (_ITEM, _ITEM_DELIM, _SEQ_DELIM):
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if tag == _ITEM and length != 0xFFFFFFFF:
                pos += length
            continue
        if explicit and group != 0xFFFE:
            vr = buf[pos:pos + 2]
            pos += 2
            if vr in _LONG_VRS:
                pos += 2
                (length,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            else:
                (length,) = struct.unpack_from("<H", buf, pos)
                pos += 2
        else:
            vr = b"UN"
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4

        if length == 0xFFFFFFFF:
            # undefined length (sequence): skip to matching delimiter
            depth = 1
            while pos + 8 <= n and depth:
                g2, e2 = struct.unpack_from("<HH", buf, pos)
                (l2,) = struct.unpack_from("<I", buf, pos + 4)
                pos += 8
                t2 = (g2, e2)
                if t2 == _SEQ_DELIM:
                    depth -= 1
                elif t2 == _ITEM:
                    if l2 != 0xFFFFFFFF:
                        pos += l2
                elif l2 != 0xFFFFFFFF and t2 != _ITEM_DELIM:
                    pos += l2
            continue

        value = buf[pos:pos + length]
        pos += length
        if tag == PIXEL_DATA:
            pixel_data = value
            if stop_at_pixels:
                break
            continue
        if vr != b"SQ":
            tags[tag] = value
    return tags, pixel_data


def _decode_str(b: bytes) -> str:
    return b.decode("latin-1", "replace").strip("\x00 ").strip()


def _decode_multi_float(b: bytes):
    return [float(x) for x in _decode_str(b).split("\\") if x]


def read_dicom(path) -> DicomSlice:
    raw = Path(path).read_bytes()
    if raw[128:132] != b"DICM":
        # some files omit the preamble; try parsing from 0 (implicit LE)
        meta_end, ts = 0, IMPLICIT_LE
    else:
        # File meta group: always explicit LE. Find its end FIRST and parse
        # ONLY group 0002 — parsing the whole file as explicit-VR here would
        # walk into an implicit-LE dataset misreading payload bytes as VRs
        # (garbage lengths -> struct.error on a perfectly valid file).
        meta_end = _find_dataset_start(raw, 132)
        meta, _ = _parse_elements(raw[:meta_end], 132, explicit=True,
                                  stop_at_pixels=False)
        ts = _decode_str(meta.get(TRANSFER_SYNTAX, EXPLICIT_LE.encode()))

    if ts not in (EXPLICIT_LE, IMPLICIT_LE):
        raise NotImplementedError(
            f"compressed/unsupported transfer syntax {ts} in {path}")

    tags, pixel_data = _parse_elements(
        raw, meta_end, explicit=(ts == EXPLICIT_LE), stop_at_pixels=True)
    if pixel_data is None:
        raise ValueError(f"no PixelData in {path}")

    rows = struct.unpack("<H", tags[ROWS][:2])[0]
    cols = struct.unpack("<H", tags[COLS][:2])[0]
    bits = struct.unpack("<H", tags.get(BITS_ALLOCATED, b"\x10\x00")[:2])[0]
    signed = struct.unpack(
        "<H", tags.get(PIXEL_REPRESENTATION, b"\x00\x00")[:2])[0]
    dt = {(8, 0): np.uint8, (8, 1): np.int8,
          (16, 0): np.uint16, (16, 1): np.int16,
          (32, 0): np.uint32, (32, 1): np.int32}[(bits, signed)]
    px = np.frombuffer(pixel_data, dtype=dt,
                       count=rows * cols).reshape(rows, cols)

    slope = float(_decode_str(tags.get(RESCALE_SLOPE, b"1")) or 1)
    inter = float(_decode_str(tags.get(RESCALE_INTERCEPT, b"0")) or 0)
    pixels = px.astype(np.float32) * slope + inter
    return DicomSlice(tags=tags, pixels=pixels)


def _find_dataset_start(raw: bytes, pos: int) -> int:
    """Walk explicit-LE elements while group == 0002; return first offset
    after the file meta group."""
    n = len(raw)
    while pos + 8 <= n:
        group, _elem = struct.unpack_from("<HH", raw, pos)
        if group != 0x0002:
            return pos
        vr = raw[pos + 6:pos + 8]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", raw, pos + 10)
            pos += 12 + length
        else:
            (length,) = struct.unpack_from("<H", raw, pos + 6)
            pos += 8 + length
    return pos


@dataclass
class DicomSeries:
    volume: np.ndarray  # (D, H, W) float32
    spacing: tuple  # (x, y, z)
    origin: tuple
    metadata: dict = field(default_factory=dict)


def read_dicom_series(series_dir) -> DicomSeries:
    """All .dcm files in a directory -> sorted, stacked volume + metadata
    (the 7 tags the reference records, convert_dicom_to_nifti.py:83-91)."""
    files = sorted(Path(series_dir).glob("*.dcm")) or sorted(
        p for p in Path(series_dir).iterdir() if p.is_file())
    slices = []
    for f in files:
        try:
            slices.append(read_dicom(f))
        except (ValueError, NotImplementedError, KeyError) as e:
            raise type(e)(f"{f}: {e}") from e
    if not slices:
        raise ValueError(f"no DICOM slices in {series_dir}")

    first = slices[0]
    orient = first.tag(IMAGE_ORIENTATION)
    if orient is not None and first.tag(IMAGE_POSITION) is not None:
        o = _decode_multi_float(orient)
        normal = np.cross(o[:3], o[3:6])
        key = [float(np.dot(_decode_multi_float(s.tags[IMAGE_POSITION]),
                            normal)) for s in slices]
        order = np.argsort(key)
    else:
        order = np.argsort([
            int(_decode_str(s.tag(INSTANCE_NUMBER, b"0")) or 0)
            for s in slices])
    slices = [slices[i] for i in order]

    vol = np.stack([s.pixels for s in slices])
    ps = _decode_multi_float(first.tag(PIXEL_SPACING, b"1\\1"))
    if len(slices) > 1 and first.tag(IMAGE_POSITION) is not None:
        p0 = np.array(_decode_multi_float(slices[0].tags[IMAGE_POSITION]))
        p1 = np.array(_decode_multi_float(slices[1].tags[IMAGE_POSITION]))
        dz = float(np.linalg.norm(p1 - p0))
    else:
        dz = float(_decode_str(first.tag(SLICE_THICKNESS, b"1")) or 1)
    origin = tuple(_decode_multi_float(
        first.tag(IMAGE_POSITION, b"0\\0\\0")))

    meta = {
        "modality": _decode_str(first.tag(MODALITY, b"")),
        "series_description": _decode_str(first.tag(SERIES_DESC, b"")),
        "study_date": _decode_str(first.tag(STUDY_DATE, b"")),
        "slice_thickness": _decode_str(first.tag(SLICE_THICKNESS, b"")),
        "pixel_spacing": "\\".join(map(str, ps)),
        "manufacturer": _decode_str(first.tag(MANUFACTURER, b"")),
        "model_name": _decode_str(first.tag(MODEL_NAME, b"")),
        "series_uid": _decode_str(first.tag(SERIES_UID, b"")),
        "num_slices": len(slices),
        "size": list(vol.shape[::-1]),
    }
    return DicomSeries(volume=vol, spacing=(ps[1], ps[0], dz),
                       origin=origin, metadata=meta)


# ---------------------------------------------------------------------------
# writer (for tests / synthetic data)
# ---------------------------------------------------------------------------

def write_dicom_slice(path, pixels: np.ndarray, instance: int,
                      position=(0.0, 0.0, 0.0), spacing=(1.0, 1.0),
                      thickness=2.5, modality="CT", series_uid="1.2.3.4",
                      slope=1.0, intercept=0.0):
    """Write a minimal explicit-VR-LE DICOM slice (test fixture writer)."""
    px = np.asarray(pixels)
    assert px.dtype == np.int16

    def el(tag, vr, value: bytes):
        g, e = tag
        if vr in (b"OB", b"OW"):
            return struct.pack("<HH2sHI", g, e, vr, 0, len(value)) + value
        if len(value) % 2:
            value += b" " if vr != b"UI" else b"\x00"
        return struct.pack("<HH2sH", g, e, vr, len(value)) + value

    meta = el(TRANSFER_SYNTAX, b"UI", EXPLICIT_LE.encode())
    body = b"".join([
        el(STUDY_DATE, b"DA", b"20240101"),
        el(MODALITY, b"CS", modality.encode()),
        el(MANUFACTURER, b"LO", b"synthetic"),
        el(SERIES_DESC, b"LO", b"synthetic series"),
        el(MODEL_NAME, b"LO", b"synth-1"),
        el(SERIES_UID, b"UI", series_uid.encode()),
        el(INSTANCE_NUMBER, b"IS", str(instance).encode()),
        el(IMAGE_POSITION, b"DS",
           "\\".join(f"{p:g}" for p in position).encode()),
        el(IMAGE_ORIENTATION, b"DS", b"1\\0\\0\\0\\1\\0"),
        el(SLICE_THICKNESS, b"DS", f"{thickness:g}".encode()),
        el(ROWS, b"US", struct.pack("<H", px.shape[0])),
        el(COLS, b"US", struct.pack("<H", px.shape[1])),
        el(PIXEL_SPACING, b"DS",
           f"{spacing[0]:g}\\{spacing[1]:g}".encode()),
        el(BITS_ALLOCATED, b"US", struct.pack("<H", 16)),
        el(PIXEL_REPRESENTATION, b"US", struct.pack("<H", 1)),
        el(RESCALE_INTERCEPT, b"DS", f"{intercept:g}".encode()),
        el(RESCALE_SLOPE, b"DS", f"{slope:g}".encode()),
        el(PIXEL_DATA, b"OW", px.tobytes()),
    ])
    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + meta + body)

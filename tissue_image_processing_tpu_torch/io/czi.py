"""Native CZI (Zeiss ZISRAW) reader — no aicsimageio/Bio-Formats dependency.

The reference ingests .czi movies through aicsimageio (``readwrite.py:19-69``,
``basic_image_manipulations.py:54-77``); that stack is not available here, so
this module parses the ZISRAW container directly:

- 32-byte segment headers (``Id[16] | AllocatedSize i64 | UsedSize i64``),
  32-byte aligned: ``ZISRAWFILE`` (file header), ``ZISRAWDIRECTORY`` (subblock
  directory), ``ZISRAWSUBBLOCK`` (pixel tiles), ``ZISRAWMETADATA`` (XML).
- DirectoryEntryDV: pixel type, file position, compression, and a list of
  DimensionEntryDV1 (dimension name, start, size) covering X/Y/C/Z/T/S/M...
- Subblock payload: ``{MetadataSize i32 | AttachmentSize i32 | DataSize i64 |
  DirectoryEntryDV}`` padded so data starts at ``max(256, 16 + entry_size)``.

Supported: uncompressed subblocks (compression 0) and zstd-compressed ones
(compression 5 "zstd0" and 6 "zstd1", including zstd1's hi-lo byte packing) of
Gray8/Gray16/Gray32Float — real ZEN acquisitions default to zstd. JPEG /
JPEG-XR subblocks have no codec in this environment and raise with a
documented conversion path (docs/MIGRATION.md).

Reads are lazy: the directory is parsed once; each ``read_frame``/slice mmaps
only the subblocks intersecting the request (the dask-virtual-read equivalent,
``read_virtual_image`` ``basic_image_manipulations.py:59-62``).

Copied from ``tissue_image_processing_tpu/io/czi.py``: host code, the same
functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["CziFile", "read_czi", "czi_to_store"]

_PIXEL_DTYPES = {
    0: np.dtype("uint8"),      # Gray8
    1: np.dtype("uint16"),     # Gray16
    2: np.dtype("float32"),    # Gray32Float
}


def _zstd_decode(raw: bytes, nbytes: int, itemsize: int, zstd1: bool) -> bytes:
    """Decode a zstd0 (compression 5) / zstd1 (compression 6) subblock payload.

    zstd1 prepends a small header to the zstd stream: byte 0 is the total
    header size, followed by (chunk-id, payload) pairs; the only defined chunk
    (id 1, 1-byte payload) flags "hi-lo byte packing" — the encoder split each
    16-bit sample and stored all low bytes before all high bytes (better zstd
    ratios on gradient-heavy microscopy data), so decoding re-interleaves.
    The reference reads compressed CZIs through aicsimageio/Bio-Formats
    (``readwrite.py:19-69``); here zstd decodes natively via ``zstandard``.
    """
    try:
        import zstandard
    except ImportError as e:  # pragma: no cover - zstandard ships in the env
        raise ValueError(
            "zstd-compressed CZI subblock but the 'zstandard' module is not "
            "installed — `pip install zstandard` or re-export uncompressed"
        ) from e
    hilo = False
    if zstd1:
        if not raw:
            raise ValueError("empty zstd1 subblock payload")
        hsize = raw[0]
        if hsize < 1 or hsize > len(raw):
            raise ValueError(f"corrupt zstd1 header (declared size {hsize})")
        p = 1
        while p < hsize:
            chunk_id = raw[p]
            p += 1
            if chunk_id == 1:
                if p >= hsize:
                    raise ValueError("truncated zstd1 hi-lo packing chunk")
                hilo = bool(raw[p] & 1)
                p += 1
            else:
                # chunk sizes are not self-describing; an unknown id means a
                # newer writer — fail loudly rather than misread pixels
                raise ValueError(f"unknown zstd1 header chunk id {chunk_id}")
        raw = raw[hsize:]
    out = zstandard.ZstdDecompressor().decompress(
        raw, max_output_size=max(nbytes, 1))
    if len(out) != nbytes:
        raise ValueError(f"zstd subblock decoded to {len(out)} bytes, "
                         f"expected {nbytes}")
    if hilo:
        if itemsize != 2:
            raise ValueError(
                "zstd1 hi-lo byte packing is only defined for 16-bit pixels")
        b = np.frombuffer(out, np.uint8)
        half = b.size // 2
        inter = np.empty(b.size, np.uint8)
        inter[0::2] = b[:half]   # low bytes first in the packed stream
        inter[1::2] = b[half:]
        out = inter.tobytes()
    return out


@dataclass
class SubBlock:
    file_position: int
    compression: int
    pixel_type: int
    dims: Dict[str, Tuple[int, int]]  # name -> (start, size)

    def coord(self, name: str, default: int = 0) -> int:
        return self.dims.get(name, (default, 1))[0]

    def size(self, name: str, default: int = 1) -> int:
        return self.dims.get(name, (0, default))[1]


@dataclass
class CziFile:
    """Parsed CZI container with lazy subblock reads."""

    path: str
    subblocks: List[SubBlock] = field(default_factory=list)
    metadata_xml: Optional[str] = None
    _mm: Optional[mmap.mmap] = None

    # -- parsing --------------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "CziFile":
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self = cls(path=path)
        self._mm = mm
        sid, _, used = cls._segment_header(mm, 0)
        if sid != "ZISRAWFILE":
            raise ValueError(f"{path}: not a CZI file (leading segment {sid!r})")
        hdr = mm[32:32 + used]
        directory_pos = struct.unpack_from("<q", hdr, 36 + 16)[0]
        metadata_pos = struct.unpack_from("<q", hdr, 36 + 24)[0]
        if metadata_pos > 0:
            self.metadata_xml = cls._read_metadata(mm, metadata_pos)
        if directory_pos > 0:
            self.subblocks = cls._read_directory(mm, directory_pos)
        else:
            self.subblocks = cls._scan_subblocks(mm)
        return self

    @staticmethod
    def _segment_header(mm, pos) -> Tuple[str, int, int]:
        sid = bytes(mm[pos:pos + 16]).rstrip(b"\x00").decode("ascii", "replace")
        alloc, used = struct.unpack_from("<qq", mm, pos + 16)
        return sid, alloc, used

    @staticmethod
    def _read_metadata(mm, pos) -> str:
        sid, _, _ = CziFile._segment_header(mm, pos)
        if sid != "ZISRAWMETADATA":
            return ""
        xml_size = struct.unpack_from("<i", mm, pos + 32)[0]
        return bytes(mm[pos + 32 + 256: pos + 32 + 256 + xml_size]).decode(
            "utf-8", "replace")

    @staticmethod
    def _parse_entry_dv(buf, off) -> Tuple[SubBlock, int]:
        schema = bytes(buf[off:off + 2])
        if schema != b"DV":
            raise ValueError(f"unsupported directory entry schema {schema!r}")
        pixel_type, = struct.unpack_from("<i", buf, off + 2)
        file_pos, = struct.unpack_from("<q", buf, off + 6)
        compression, = struct.unpack_from("<i", buf, off + 18)
        dim_count, = struct.unpack_from("<i", buf, off + 28)
        dims: Dict[str, Tuple[int, int]] = {}
        p = off + 32
        for _ in range(dim_count):
            name = bytes(buf[p:p + 4]).rstrip(b"\x00").decode("ascii", "replace")
            start, size = struct.unpack_from("<ii", buf, p + 4)
            dims[name] = (start, size)
            p += 20
        return SubBlock(file_pos, compression, pixel_type, dims), p - off

    @classmethod
    def _read_directory(cls, mm, pos) -> List[SubBlock]:
        sid, _, used = cls._segment_header(mm, pos)
        if sid != "ZISRAWDIRECTORY":
            raise ValueError(f"directory segment missing at {pos} (got {sid!r})")
        buf = mm[pos + 32: pos + 32 + used]
        count = struct.unpack_from("<i", buf, 0)[0]
        entries = []
        off = 128
        for _ in range(count):
            sb, consumed = cls._parse_entry_dv(buf, off)
            entries.append(sb)
            off += consumed
        return entries

    @classmethod
    def _scan_subblocks(cls, mm) -> List[SubBlock]:
        """Fallback: walk segments sequentially (no directory, e.g. truncated
        write)."""
        out = []
        pos = 0
        n = len(mm)
        while pos + 32 <= n:
            sid, alloc, used = cls._segment_header(mm, pos)
            if not sid.startswith("ZISRAW"):
                break
            if sid == "ZISRAWSUBBLOCK":
                buf = mm[pos + 32: pos + 32 + min(used, 4096)]
                sb, _ = cls._parse_entry_dv(buf, 16)
                sb.file_position = pos
                out.append(sb)
            pos += 32 + alloc
        return out

    # -- dimension model ------------------------------------------------------

    def dim_origins(self) -> Dict[str, int]:
        """Minimum start per dimension — mosaics acquired with a non-zero
        global stage offset place tiles at large raw X/Y starts; all reads
        normalize by subtracting these."""
        out: Dict[str, int] = {}
        for sb in self.subblocks:
            for name, (start, _size) in sb.dims.items():
                out[name] = min(out.get(name, start), start)
        return out

    def dims(self) -> Dict[str, int]:
        """Overall EXTENT per dimension: max(start+size) - min(start)."""
        out: Dict[str, int] = {}
        origins = self.dim_origins()
        for sb in self.subblocks:
            for name, (start, size) in sb.dims.items():
                out[name] = max(out.get(name, 0), start + size - origins[name])
        return out

    def shape_tczyx(self) -> Tuple[int, int, int, int, int]:
        d = self.dims()
        return (max(d.get("T", 1), 1), max(d.get("C", 1), 1),
                max(d.get("Z", 1), 1), max(d.get("Y", 1), 1),
                max(d.get("X", 1), 1))

    @property
    def dtype(self) -> np.dtype:
        if not self.subblocks:
            return np.dtype("uint16")
        pt = self.subblocks[0].pixel_type
        if pt not in _PIXEL_DTYPES:
            raise ValueError(f"unsupported CZI pixel type {pt} "
                             f"(supported: Gray8/Gray16/Gray32Float)")
        return _PIXEL_DTYPES[pt]

    # -- lazy reads -----------------------------------------------------------

    def _subblock_pixels(self, sb: SubBlock) -> np.ndarray:
        mm = self._mm
        pos = sb.file_position
        sid, _, _ = self._segment_header(mm, pos)
        if sid != "ZISRAWSUBBLOCK":
            raise ValueError(f"subblock missing at {pos} (got {sid!r})")
        meta_size, _attach = struct.unpack_from("<ii", mm, pos + 32)
        data_size, = struct.unpack_from("<q", mm, pos + 40)
        _, entry_size = self._parse_entry_dv(mm[pos + 48: pos + 48 + 4096], 0)
        data_off = pos + 32 + max(256, 16 + entry_size) + meta_size
        dt = _PIXEL_DTYPES[sb.pixel_type]
        h, w = sb.size("Y"), sb.size("X")
        if sb.compression == 0:
            arr = np.frombuffer(mm, dtype=dt, count=h * w, offset=data_off)
            return arr.reshape(h, w)
        if sb.compression in (5, 6):  # zstd0 / zstd1 — the ZEN default codecs
            raw = bytes(mm[data_off:data_off + data_size])
            buf = _zstd_decode(raw, h * w * dt.itemsize, dt.itemsize,
                               zstd1=(sb.compression == 6))
            return np.frombuffer(buf, dtype=dt, count=h * w).reshape(h, w)
        name = {1: "JPEG", 2: "LZW", 4: "JPEG-XR"}.get(
            sb.compression, f"unknown ({sb.compression})")
        raise ValueError(
            f"CZI subblock uses {name} compression, which has no available "
            "codec in this environment — re-export from ZEN with zstd or no "
            "compression, or convert once with Bio-Formats "
            "(`bfconvert in.czi out.ome.tiff`); see docs/MIGRATION.md "
            "'Compressed CZI files'")

    def read_frame(self, t: int = 0, c: int = 0, z: int = 0,
                   s: int = 0) -> np.ndarray:
        """(Y, X) plane assembled from every subblock at (T=t, C=c, Z=z, S=s) —
        mosaic tiles land at their X/Y start offsets. Only the needed subblocks
        are touched (lazy)."""
        d = self.dims()
        org = self.dim_origins()
        out = np.zeros((max(d.get("Y", 1), 1), max(d.get("X", 1), 1)),
                       self.dtype)
        found = False
        for sb in self.subblocks:
            if (sb.coord("T") - org.get("T", 0) != t and "T" in sb.dims) or \
               (sb.coord("C") - org.get("C", 0) != c and "C" in sb.dims) or \
               (sb.coord("Z") - org.get("Z", 0) != z and "Z" in sb.dims) or \
               (sb.coord("S") - org.get("S", 0) != s and "S" in sb.dims):
                continue
            px = self._subblock_pixels(sb)
            y0 = sb.coord("Y") - org.get("Y", 0)
            x0 = sb.coord("X") - org.get("X", 0)
            out[y0:y0 + px.shape[0], x0:x0 + px.shape[1]] = px
            found = True
        if not found:
            raise IndexError(f"no subblock at T={t} C={c} Z={z} S={s}")
        return out

    def read_whole(self, s: int = 0) -> np.ndarray:
        """Full (T, C, Z, Y, X) array (reference ``read_whole_image``,
        ``basic_image_manipulations.py:54-57``)."""
        T, C, Z, Y, X = self.shape_tczyx()
        out = np.zeros((T, C, Z, Y, X), self.dtype)
        for t in range(T):
            for c in range(C):
                for z in range(Z):
                    try:
                        out[t, c, z] = self.read_frame(t, c, z, s)
                    except IndexError:
                        pass  # truncated/sparse acquisition: leave plane zero
        return out

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_czi(path: str) -> np.ndarray:
    """One-shot TCZYX read (reference ``read_whole_image``)."""
    with CziFile.open(path) as f:
        return f.read_whole()


def czi_to_store(paths, out_path: str, pad_to_max: bool = True):
    """Two-pass conversion of a multi-file .czi series into one chunked movie
    store, padding every file to the max XYZ and concatenating along T — the
    store counterpart of ``convert_czi_to_ZDataset`` (``readwrite.py:19-69``,
    which writes a dexp ZDataset; here the target is the mmap-backed
    :class:`~tissue_image_processing_tpu_torch.io.movie.MovieStore`).
    """
    from tissue_image_processing_tpu_torch.io.movie import MovieStore

    files = [CziFile.open(p) for p in paths]
    try:
        shapes = [f.shape_tczyx() for f in files]
        T_total = sum(s[0] for s in shapes)
        C = max(s[1] for s in shapes)
        Z = max(s[2] for s in shapes)
        Y = max(s[3] for s in shapes)
        X = max(s[4] for s in shapes)
        store = MovieStore.create(out_path, (T_total, C, Z, Y, X),
                                  dtype=files[0].dtype)
        t_out = 0
        for f, (T, c, z, y, x) in zip(files, shapes):
            for t in range(T):
                frame = np.zeros((C, Z, Y, X), files[0].dtype)
                for ci in range(c):
                    for zi in range(z):
                        try:
                            plane = f.read_frame(t, ci, zi)
                        except IndexError:
                            continue  # sparse acquisition: leave plane zero
                        frame[ci, zi, :plane.shape[0], :plane.shape[1]] = plane
                store.write_frame(t_out, frame)
                t_out += 1
        return store
    finally:
        for f in files:
            f.close()

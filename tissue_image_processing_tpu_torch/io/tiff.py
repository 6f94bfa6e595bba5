"""TIFF read/write on PIL with 5-D (TCZYX) axis handling and OME-XML metadata.

Mirrors the reference's reader/writer API surface (``read_tiff``/``save_tiff``,
``basic_image_manipulations.py:28-51,162-189``): multi-page TIFFs are (de)serialized
page-major in axis order. The reference writes OME-TIFF through aicsimageio's
``OmeTiffWriter`` (``basic_image_manipulations.py:162-189``); here the first IFD's
ImageDescription carries a minimal OME-XML document (Image/Pixels with
DimensionOrder, Size*, PhysicalSize* — enough for Fiji/aicsimageio/the reference to
recover axes and pixel sizes) with the writer's full metadata dict embedded as a
JSON ``XMLAnnotation`` so round-trips preserve the exact axes/shape and any extra
keys. Legacy files whose description is the bare JSON of earlier versions still
read. uint8/uint16/float32 supported.

Copied from ``tissue_image_processing_tpu/io/tiff.py``: host code, the same
functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Optional, Tuple
from xml.sax.saxutils import escape

import numpy as np

try:
    from PIL import Image
    from PIL.TiffImagePlugin import ImageFileDirectory_v2

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False

_DESC_TAG = 270

UINT8_MAXVAL = 255
UINT16_MAXVAL = 65535


def _require_pil():
    if not _HAVE_PIL:
        raise RuntimeError("PIL is required for TIFF I/O")


_OME_NS = "http://www.openmicroscopy.org/Schemas/OME/2016-06"
_OME_TYPES = {"uint8": "uint8", "uint16": "uint16", "int16": "int16",
              "uint32": "uint32", "int32": "int32", "float32": "float",
              "float64": "double"}
# OME DimensionOrder must be one of the six XY-first permutations; our pages
# iterate the trailing non-YX axis fastest, so the order after "XY" is the
# reversed non-YX axis string, padded with the missing letters.
_OME_ORDERS = {"XYZCT", "XYZTC", "XYCTZ", "XYCZT", "XYTCZ", "XYTZC"}


def _ome_dimension_order(axes: str) -> str:
    rest = [a for a in axes if a not in "YX"]
    fastest_first = "".join(reversed(rest))
    # fold non-OME letters (e.g. the 'Q' placeholder) into whichever of T/C/Z
    # is still free, T first (a bare page axis is closest to "time/series")
    out = []
    free = [a for a in "TCZ" if a not in fastest_first]
    for a in fastest_first:
        out.append(a if a in "TCZ" and a not in out else (free.pop(0) if free else None))
    out = [a for a in out if a]
    for a in "ZCT":
        if a not in out:
            out.append(a)
    order = "XY" + "".join(out[:3])
    return order if order in _OME_ORDERS else "XYZCT"


def _ome_sizes(axes: str, shape) -> dict:
    sizes = {a: 1 for a in "XYZCT"}
    for a, s in zip(axes, shape):
        key = a if a in "XYZCT" else None
        if key is None:  # placeholder axis: fold into the first free slot
            for cand in "TCZ":
                if all(b != cand for b in axes):
                    key = cand
                    break
        if key is not None:
            sizes[key] *= int(s)
    return sizes


def build_ome_xml(axes: str, shape, dtype: str, metadata: Optional[dict] = None,
                  name: str = "image") -> str:
    """Minimal OME-XML (2016-06 schema) for one image: Pixels carries
    DimensionOrder/Size*/Type and PhysicalSize* (um) when the metadata dict has
    ``physical_size_z/y/x`` keys (the reference's ``update_projection_metadata``
    contract, ``surface_projection.py:319-327``); the full metadata dict plus
    the exact axes/shape ride as a JSON XMLAnnotation so round-trips are
    lossless."""
    meta = dict(metadata or {})
    sizes = _ome_sizes(axes, shape)
    phys = ""
    for ome_key, meta_key in (("PhysicalSizeX", "physical_size_x"),
                              ("PhysicalSizeY", "physical_size_y"),
                              ("PhysicalSizeZ", "physical_size_z")):
        if meta.get(meta_key) is not None:
            phys += (f' {ome_key}="{float(meta[meta_key])}"'
                     f' {ome_key}Unit="µm"')
    payload = dict(meta)
    payload["axes"] = axes
    payload["shape"] = [int(s) for s in shape]
    annotation = escape(json.dumps(payload))
    ome_type = _OME_TYPES.get(str(dtype), "uint16")
    n_pages = int(np.prod([int(s) for s in shape[:-2]], dtype=np.int64)) if len(shape) > 2 else 1
    return (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<OME xmlns="{_OME_NS}" '
        f'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
        f'xsi:schemaLocation="{_OME_NS} {_OME_NS}/ome.xsd">'
        f'<Image ID="Image:0" Name="{escape(str(name))}">'
        f'<Pixels ID="Pixels:0" DimensionOrder="{_ome_dimension_order(axes)}" '
        f'Type="{ome_type}" SizeX="{sizes["X"]}" SizeY="{sizes["Y"]}" '
        f'SizeZ="{sizes["Z"]}" SizeC="{sizes["C"]}" SizeT="{sizes["T"]}"{phys}>'
        f'<TiffData IFD="0" PlaneCount="{n_pages}"/>'
        f'</Pixels></Image>'
        f'<StructuredAnnotations>'
        # the JAX package's namespace: both packages write the same bytes
        f'<XMLAnnotation ID="Annotation:0" Namespace="tissue_image_processing_tpu">'
        f'<Value><OriginalMetadata>{annotation}</OriginalMetadata></Value>'
        f'</XMLAnnotation></StructuredAnnotations></OME>')


def parse_ome_xml(desc: str) -> dict:
    """Parse an OME-XML ImageDescription into the reader's metadata dict.

    The JSON XMLAnnotation (when present — files we wrote) restores the exact
    axes/shape and extra keys; otherwise axes/shape/physical sizes are derived
    from the Pixels attributes alone, so third-party OME-TIFFs read too."""
    root = ET.fromstring(desc)

    def find(tag):
        return root.iter(f"{{{_OME_NS}}}{tag}")

    meta: dict = {}
    pixels = next(iter(find("Pixels")), None)
    if pixels is None:  # namespace-less or other OME versions: match local names
        for el in root.iter():
            if el.tag.rsplit("}", 1)[-1] == "Pixels":
                pixels = el
                break
    if pixels is not None:
        order = pixels.get("DimensionOrder", "XYZCT")
        sizes = {a: int(pixels.get(f"Size{a}", 1) or 1) for a in "XYZCT"}
        # page-major axes = reversed post-XY dimension order + YX
        meta["axes"] = "".join(reversed(order[2:])) + "YX"
        meta["shape"] = [sizes[a] for a in meta["axes"]]
        for ome_key, meta_key in (("PhysicalSizeX", "physical_size_x"),
                                  ("PhysicalSizeY", "physical_size_y"),
                                  ("PhysicalSizeZ", "physical_size_z")):
            if pixels.get(ome_key) is not None:
                meta[meta_key] = float(pixels.get(ome_key))
        meta["SizeT"] = sizes["T"]
    for el in root.iter():
        if el.tag.rsplit("}", 1)[-1] == "OriginalMetadata" and el.text:
            try:
                meta.update(json.loads(el.text))
            except Exception:
                pass
    return meta


def read_tiff_description(im) -> dict:
    """Metadata dict from an open PIL image's first-IFD ImageDescription:
    OME-XML (current format), legacy bare-JSON, or {}."""
    try:
        desc = im.tag_v2.get(_DESC_TAG) if hasattr(im, "tag_v2") else None
        if isinstance(desc, bytes):
            desc = desc.decode("utf-8", "replace")
        elif isinstance(desc, str):
            # the tag holds UTF-8 bytes (we write them so 'µm' survives on
            # disk) but PIL decodes ASCII tags as latin-1; undo that
            try:
                desc = desc.encode("latin-1").decode("utf-8")
            except (UnicodeDecodeError, UnicodeEncodeError):
                pass
        if desc and str(desc).lstrip().startswith("<"):
            return parse_ome_xml(str(desc))
        if desc:
            return json.loads(desc)
    except Exception:
        pass
    return {}


def read_tiff(path: str):
    """Read a (multi-page) TIFF.

    Returns (image, axes, shape, metadata) like the reference ``read_tiff``
    (``basic_image_manipulations.py:28-51``). Axes are recovered from the
    description JSON written by :func:`save_tiff`; otherwise pages are returned
    as a leading axis ('QYX' for multipage, 'YX' for single page).
    """
    _require_pil()
    with Image.open(path) as im:
        pages = []
        meta = read_tiff_description(im)
        n = getattr(im, "n_frames", 1)
        for i in range(n):
            im.seek(i)
            pages.append(np.array(im))
    arr = np.stack(pages, axis=0) if len(pages) > 1 else pages[0][None]
    axes = meta.get("axes")
    shape = meta.get("shape")
    # only reshape when the metadata actually describes THIS file's pages: a
    # multi-file OME series member carries the whole series' Size* in its XML
    # (Bio-Formats convention), and the declared page count then exceeds the
    # file's — fall back to pages-as-leading-axis for those
    if (axes and shape and len(axes) == len(shape)
            and int(np.prod(shape, dtype=np.int64)) == arr.size
            and tuple(shape[-2:]) == arr.shape[-2:]):
        arr = arr.reshape(tuple(shape))
    elif arr.shape[0] == 1:
        arr = arr[0]
        axes = "YX"
    else:
        axes = "QYX"
    return arr, axes, arr.shape, meta


def save_tiff(path: str, image: np.ndarray, metadata: Optional[dict] = None,
              axes: str = "", data_type: str = "") -> None:
    """Save an N-D array as an OME-TIFF (reference ``save_tiff``,
    ``basic_image_manipulations.py:162-189`` — aicsimageio OmeTiffWriter):
    optional rescale to uint8/uint16 (divide by max, scale to dtype range);
    the first IFD's ImageDescription is OME-XML (:func:`build_ome_xml`) so
    Fiji/aicsimageio consumers see axes and physical pixel sizes."""
    _require_pil()
    image = np.asarray(image)
    if data_type and str(image.dtype) != data_type and data_type in ("uint8", "uint16"):
        max_val = UINT8_MAXVAL if data_type == "uint8" else UINT16_MAXVAL
        denom = image.max() if image.max() > 0 else 1
        image = np.round(image / denom * max_val).astype(data_type)
    if image.dtype == np.float64:
        image = image.astype(np.float32)
    axes = axes or "Q" * (image.ndim - 2) + "YX"
    pages_arr = image.reshape((-1,) + image.shape[-2:])
    frames = [Image.fromarray(p) for p in pages_arr]
    ifd = ImageFileDirectory_v2()
    # UTF-8 BYTES, not str: PIL encodes ASCII tags with errors='replace',
    # which turned the OME unit 'µm' into '?m' (an invalid UnitsLength for
    # Bio-Formats/ome-types); raw bytes pass through verbatim
    ifd[_DESC_TAG] = build_ome_xml(axes, image.shape, str(image.dtype),
                                   metadata,
                                   name=os.path.basename(path)).encode("utf-8")
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   tiffinfo=ifd, compression=None)


def read_whole_image(path: str):
    """Read any supported container into a TCZYX numpy array + axes string
    (reference ``read_whole_image``, ``basic_image_manipulations.py:54-57``)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".npy",):
        arr = np.load(path)
        return arr, _default_axes(arr.ndim), arr.shape
    if ext in (".tif", ".tiff"):
        arr, axes, shape, _ = read_tiff(path)
        return arr, axes, shape
    if ext == ".czi":
        from tissue_image_processing_tpu_torch.io.czi import CziFile

        with CziFile.open(path) as f:
            arr = f.read_whole()
        return arr, "TCZYX", arr.shape
    raise ValueError(f"unsupported image container: {path}")


def _default_axes(ndim: int) -> str:
    return {2: "YX", 3: "TYX", 4: "TCYX", 5: "TCZYX"}.get(ndim, "Q" * (ndim - 2) + "YX")


def get_image_dimensions(path: str):
    """Shape probe (reference ``get_image_dimensions``,
    ``basic_image_manipulations.py:79-82``). Returns an object with T/C/Z/Y/X."""
    arr, axes, shape = read_whole_image(path)

    class Dims:
        pass

    d = Dims()
    for name in "TCZYX":
        idx = axes.find(name)
        setattr(d, name, shape[idx] if idx >= 0 else 1)
    d.shape = shape
    d.axes = axes
    return d


def to_tczyx(image: np.ndarray, axes: str) -> np.ndarray:
    """Normalize an array to the 5-D TCZYX layout used across the pipeline
    (the reference's movie contract, ``gui.py:442-444``). Placeholder axes
    (e.g. the 'Q' a metadata-less multi-page TIFF reads as) take the first
    free T/C/Z slot, T first."""
    order = "TCZYX"
    arr = image
    current = []
    for a in axes:
        if a in order and a not in current:
            current.append(a)
        else:
            free = [x for x in "TCZ" if x not in axes and x not in current]
            if not free:
                raise ValueError(f"cannot map axes {axes!r} onto TCZYX")
            current.append(free[0])
    for name in order:
        if name not in current:
            arr = arr[None]
            current.insert(0, name)
    perm = [current.index(name) for name in order]
    return np.transpose(arr, perm)

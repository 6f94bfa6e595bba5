"""Movie access: chunked iteration, concatenation, and a memory-mapped frame store.

A rethink of the reference's dask-based out-of-core slicing
(``read_virtual_image`` / ``read_image_in_chunks``,
``basic_image_manipulations.py:59-159``): instead of lazy dask graphs computed one
frame at a time, frames are staged host-side as numpy (optionally memory-mapped)
and fed to the card in T-batches (the projection driver, ``movie_pipeline_chunked``).

Copied from ``tissue_image_processing_tpu/io/movie.py``: host code, the same
functions and file formats; its imports name the port's modules.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from tissue_image_processing_tpu_torch.io.tiff import read_whole_image, to_tczyx


class _LazyFrameSource:
    """Read-only ndarray-like TCZYX view that decodes only the frames an index
    touches. Supports the access patterns the drivers use — ``data[t]``,
    ``data[t0:t1]``, ``data[:, c, z, ...]``, ``np.asarray(data)`` — by
    decoding the needed T-frames and applying the trailing index to the
    stacked host array (one frame fits in RAM even when the movie does not;
    the streaming analog of the reference's dask ``read_virtual_image``,
    ``basic_image_manipulations.py:59-62``)."""

    ndim = 5

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)

    def _read_frame(self, t: int) -> np.ndarray:  # (C, Z, Y, X)
        raise NotImplementedError

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        out = self[:]
        return out.astype(dtype) if dtype is not None else out

    def _frame_cached(self, t: int) -> np.ndarray:
        if t < 0:
            t += self.shape[0]
        if not 0 <= t < self.shape[0]:
            raise IndexError(f"frame {t} out of range [0, {self.shape[0]})")
        return self._read_frame(t)

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        tkey, rest = key[0], key[1:]
        if isinstance(tkey, (int, np.integer)):
            frame = self._frame_cached(int(tkey))
            return frame[rest] if rest else frame
        if isinstance(tkey, slice):
            ts = range(*tkey.indices(self.shape[0]))
        else:
            tarr = np.asarray(tkey)
            if tarr.dtype == bool:  # mask selects frames, not indices
                if tarr.shape != (self.shape[0],):
                    raise IndexError(
                        f"boolean index of shape {tarr.shape} does not match "
                        f"the frame axis length {self.shape[0]}")
                tarr = np.nonzero(tarr.ravel())[0]
            ts = [int(t) for t in tarr.ravel()]
        if len(ts) == 0:
            stacked = np.empty((0,) + self.shape[1:], self.dtype)
        else:
            stacked = np.stack([self._frame_cached(t) for t in ts])
        return stacked[(slice(None),) + rest] if rest else stacked


class _TiffFrameSource(_LazyFrameSource):
    """Lazy multi-page TIFF: the PIL file handle stays open and ``seek``
    decodes one page at a time. Page order follows the file's axes metadata
    (OME-XML / legacy JSON from :func:`~..io.tiff.save_tiff`); bare files
    default to pages-as-T."""

    def __init__(self, path: str):
        from PIL import Image

        from tissue_image_processing_tpu_torch.io.tiff import (_default_axes,
                                                         read_tiff_description)

        self._im = Image.open(path)
        meta = read_tiff_description(self._im)
        n_pages = getattr(self._im, "n_frames", 1)
        page_shape = (self._im.height, self._im.width)
        axes = meta.get("axes")
        shape = tuple(meta.get("shape") or ())
        if not (axes and shape and len(axes) == len(shape)
                and int(np.prod(shape[:-2], dtype=np.int64)) == n_pages
                and tuple(shape[-2:]) == page_shape):
            # no/foreign metadata (e.g. a multi-file OME series member whose
            # XML declares the whole series' sizes): pages stream as T
            shape = ((n_pages,) + page_shape) if n_pages > 1 else page_shape
            axes = _default_axes(len(shape))
        if len(shape) > 5:
            self._im.close()  # don't leak the handle on the error path
            raise ValueError(
                f"cannot stream a {len(shape)}-D TIFF as a TCZYX store "
                f"(axes {axes!r}); read it eagerly via read_tiff instead")
        # (T, C, Z) array of page numbers: reshape the page counter to the
        # file's leading axes, then normalize exactly like to_tczyx
        pages = np.arange(n_pages).reshape(shape[:-2] or ())
        lead = []
        for a in axes[:-2]:
            if a in "TCZ" and a not in lead:
                lead.append(a)
            else:  # placeholder axis (e.g. 'Q'): first free slot, T first
                lead.append(next(x for x in "TCZ" if x not in lead and x not in axes[:-2]))
        for name in "TCZ":
            if name not in lead:
                pages = pages[None]
                lead.insert(0, name)
        self._pages = np.transpose(pages, [lead.index(n) for n in "TCZ"])
        t_sz, c_sz, z_sz = self._pages.shape
        super().__init__((t_sz, c_sz, z_sz) + page_shape,
                         np.array(self._im).dtype)

    def _read_frame(self, t: int) -> np.ndarray:
        planes = []
        for p in self._pages[t].ravel():
            self._im.seek(int(p))
            planes.append(np.array(self._im))
        return np.stack(planes).reshape(self.shape[1:])

    def close(self):
        self._im.close()


class _CziFrameSource(_LazyFrameSource):
    """Lazy CZI: planes decode per (t, c, z) through ``CziFile.read_frame``'s
    subblock index — only the touched subblocks are read from the mmap."""

    def __init__(self, path: str):
        from tissue_image_processing_tpu_torch.io.czi import CziFile

        self._czi = CziFile.open(path)
        super().__init__(self._czi.shape_tczyx(), self._czi.dtype)

    def _read_frame(self, t: int) -> np.ndarray:
        _, C, Z, Y, X = self.shape
        out = np.zeros((C, Z, Y, X), self.dtype)
        for c in range(C):
            for z in range(Z):
                try:
                    out[c, z] = self._czi.read_frame(t, c, z)
                except IndexError:
                    pass  # truncated/sparse acquisition: leave plane zero
        return out

    def close(self):
        self._czi.close()


class MovieStore:
    """A TCZYX movie backed by a numpy array, an .npy memory map, or a lazy
    TIFF/CZI frame source.

    The batched pipeline pulls ``frames(t0, t1)`` slices and ships them to device
    in one transfer per batch (replacing the reference's per-frame
    ``dask .compute()`` host materializations, e.g. ``gui.py:444``). All three
    container formats stream: .npy via ``np.load(mmap_mode='r')``, TIFF via
    per-page PIL decode, CZI via per-subblock reads — opening never
    materializes the movie (pass ``lazy=False`` for the old eager decode).
    """

    def __init__(self, data: np.ndarray, axes: str = "TCZYX"):
        self.data = to_tczyx(data, axes)

    @classmethod
    def open(cls, path: str, mmap: bool = True, lazy: bool = True) -> "MovieStore":
        ext = os.path.splitext(path)[1].lower()
        if ext == ".npy" and mmap:
            arr = np.load(path, mmap_mode="r")
            axes = {5: "TCZYX", 4: "TCYX", 3: "TYX", 2: "YX"}[arr.ndim]
            return cls(np.asarray(arr), axes)
        if ext == ".czi":
            if lazy:
                return cls._from_source(_CziFrameSource(path))
            from tissue_image_processing_tpu_torch.io.czi import CziFile

            with CziFile.open(path) as f:
                return cls(f.read_whole(), "TCZYX")
        if ext in (".tif", ".tiff") and lazy:
            src = _TiffFrameSource(path)
            if src.shape[0] * src.shape[1] * src.shape[2] == 1:
                src.close()  # single plane: eager is simpler and as cheap
            else:
                return cls._from_source(src)
        arr, axes, _ = read_whole_image(path)
        return cls(arr, axes)

    @classmethod
    def _from_source(cls, source: _LazyFrameSource) -> "MovieStore":
        store = cls.__new__(cls)
        store.data = source
        return store

    def close(self):
        if hasattr(self.data, "close"):
            self.data.close()

    @classmethod
    def create(cls, path: str, shape, dtype=np.uint16) -> "MovieStore":
        """Writable mmap-backed .npy store (the converter target — the
        reference writes a dexp ZDataset, ``readwrite.py:19-69``)."""
        if not path.endswith(".npy"):
            path = path + ".npy"
        arr = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                        shape=tuple(shape))
        store = cls.__new__(cls)
        store.data = arr
        return store

    def write_frame(self, t: int, frame: np.ndarray):
        """Write one (C, Z, Y, X) frame into a store opened with create()."""
        self.data[t] = frame

    @property
    def shape(self):
        return self.data.shape

    @property
    def num_frames(self) -> int:
        return self.data.shape[0]

    def frame(self, t: int) -> np.ndarray:
        """(C, Z, Y, X) single frame; ``t`` is 0-based."""
        return np.asarray(self.data[t])

    def frames(self, t0: int, t1: int) -> np.ndarray:
        """(T, C, Z, Y, X) frame batch."""
        return np.asarray(self.data[t0:t1])


def read_image_in_chunks(
    data: np.ndarray,
    dx: int = 0, dy: int = 0, dz: int = 0, dc: int = 0, dt: int = 0,
    apply_function: Optional[Callable] = None,
    output: Optional[Sequence[np.ndarray]] = None,
    **apply_function_params,
) -> Iterator:
    """Walk a 5-D TCZYX array in (dt, dc, dz, dy, dx) chunks, apply a function and
    scatter (possibly tuple) results into preallocated outputs.

    API-compatible generator with the reference's chunked-apply engine
    (``basic_image_manipulations.py:89-159``), minus the dask lazy layer: ``data``
    is a numpy array or memmap. A chunk dimension of 0 means "whole axis".
    """
    max_t, max_c, max_z, max_y, max_x = data.shape
    dt = dt or max_t
    dc = dc or max_c
    dz = dz or max_z
    dy = dy or max_y
    dx = dx or max_x
    for t in range(0, max_t, dt):
        for c in range(0, max_c, dc):
            for z in range(0, max_z, dz):
                for y in range(0, max_y, dy):
                    for x in range(0, max_x, dx):
                        chunk = np.asarray(data[t:t + dt, c:c + dc, z:z + dz,
                                                y:y + dy, x:x + dx])
                        if apply_function is None:
                            yield chunk
                            continue
                        result = apply_function(chunk, **apply_function_params)
                        if output is not None:
                            results = result if isinstance(result, tuple) else (result,)
                            outs = output if isinstance(output, (list, tuple)) else [output]
                            for res, out in zip(results, outs):
                                res = np.asarray(res)
                                ot, oc, oz, oy, ox = out.shape
                                sl = (slice(min(t, ot), min(t + dt, max_t, ot)),
                                      slice(min(c, oc), min(c + dc, max_c, oc)),
                                      slice(min(z, oz), min(z + dz, max_z, oz)),
                                      slice(min(y, oy), min(y + dy, max_y, oy)),
                                      slice(min(x, ox), min(x + dx, max_x, ox)))
                                target_shape = tuple(s.stop - s.start for s in sl)
                                out[sl] = res.reshape(target_shape)
                        yield result


def concatenate_time_points(files: List[str]) -> np.ndarray:
    """Concatenate per-movie .npy projections along T, padding interior axes to the
    first file's sizes (reference ``concatenate_time_points``,
    ``basic_image_manipulations.py:478-495``)."""
    imgs: List[np.ndarray] = []
    for file in files:
        img = np.load(file).astype("uint16")
        if imgs:
            ref = imgs[0]
            pad_width = [(0, 0)]
            for dim in range(1, img.ndim):
                diff = ref.shape[dim] - img.shape[dim]
                pad_width.append((max(diff, 0), 0))
            if any(p != (0, 0) for p in pad_width):
                img = np.pad(img, pad_width, constant_values=0)
            img = img[tuple(slice(0, s) for s in (img.shape[0],) + ref.shape[1:])]
        imgs.append(img)
    return np.concatenate(imgs, axis=0)


def virtually_concatenate_time_points(arrays: Sequence[np.ndarray],
                                      output_path: str) -> None:
    """Stream frame-major concatenation into one multi-page TIFF (reference
    ``virtually_concatenate_time_points``, ``basic_image_manipulations.py:511-520``)."""
    from tissue_image_processing_tpu_torch.io.tiff import save_tiff

    stacked = np.concatenate([np.asarray(a) for a in arrays], axis=0)
    save_tiff(output_path, stacked, axes="TZCYX"[:stacked.ndim - 2] + "YX")

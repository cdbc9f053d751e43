"""Minimal zarr-v2 directory-store reader and writer (standard library and
numpy only; a copy of ``lns_tpu.data.zarr_reader``).

PDEArena's ShallowWater-2D store is a zarr v2 directory, and the machines
this package runs on need not have the ``zarr`` package. This reader
covers the subset needed to load it: C-order chunked float arrays with no
compressor, zlib, or gzip compression. Blosc-compressed stores need the
``zarr`` package; a clear error is raised.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional, Tuple

import numpy as np


class ZarrArray:
    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ".zarray")) as f:
            meta = json.load(f)
        assert meta.get("zarr_format", 2) == 2, "only zarr v2 supported"
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        assert self.order == "C", "only C-order supported"
        self.fill_value = meta.get("fill_value", 0)
        comp = meta.get("compressor")
        self.comp_id = comp["id"] if comp else None
        if self.comp_id not in (None, "zlib", "gzip"):
            raise NotImplementedError(
                f"zarr compressor {self.comp_id!r} unsupported by the minimal "
                "reader — re-encode the store uncompressed or with zlib"
            )
        self.sep = meta.get("dimension_separator", ".")

    def _read_chunk(self, coords: Tuple[int, ...]) -> np.ndarray:
        name = self.sep.join(str(c) for c in coords)
        fp = os.path.join(self.path, name)
        if not os.path.exists(fp):
            return np.full(self.chunks, self.fill_value, self.dtype)
        with open(fp, "rb") as f:
            raw = f.read()
        if self.comp_id in ("zlib", "gzip"):
            raw = zlib.decompress(raw, zlib.MAX_WBITS | 32 if self.comp_id == "gzip" else zlib.MAX_WBITS)
        arr = np.frombuffer(raw, self.dtype)
        return arr.reshape(self.chunks)

    def __getitem__(self, key) -> np.ndarray:
        """Full-array or leading-axis-sliced reads (enough for this corpus)."""
        full = self.read_all()
        return full[key]

    def read_all(self) -> np.ndarray:
        out = np.empty(self.shape, self.dtype)
        grid = [range((s + c - 1) // c) for s, c in zip(self.shape, self.chunks)]
        import itertools

        for coords in itertools.product(*grid):
            chunk = self._read_chunk(coords)
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(coords, self.chunks, self.shape)
            )
            trims = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = chunk[trims]
        return out


class ZarrGroup:
    def __init__(self, path: str):
        self.path = path
        self._arrays = {}

    def __getitem__(self, name: str) -> ZarrArray:
        if name not in self._arrays:
            self._arrays[name] = ZarrArray(os.path.join(self.path, name))
        return self._arrays[name]

    def keys(self):
        return [
            d
            for d in os.listdir(self.path)
            if os.path.isdir(os.path.join(self.path, d))
            and os.path.exists(os.path.join(self.path, d, ".zarray"))
        ]


def open_zarr(path: str) -> ZarrGroup:
    return ZarrGroup(path)


def write_zarr_array(path: str, arr: np.ndarray, chunks: Optional[Tuple[int, ...]] = None):
    """Write an uncompressed zarr-v2 array (for tests / re-encoding)."""
    os.makedirs(path, exist_ok=True)
    chunks = chunks or arr.shape
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(chunks),
        "dtype": arr.dtype.str,
        "compressor": None,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    grid = [range((s + c - 1) // c) for s, c in zip(arr.shape, chunks)]
    import itertools

    for coords in itertools.product(*grid):
        slices = tuple(
            slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(coords, chunks, arr.shape)
        )
        chunk = np.zeros(chunks, arr.dtype)
        sel = arr[slices]
        chunk[tuple(slice(0, x) for x in sel.shape)] = sel
        name = ".".join(str(c) for c in coords)
        chunk.tofile(os.path.join(path, name))

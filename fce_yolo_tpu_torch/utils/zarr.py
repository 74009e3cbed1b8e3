"""zarr v2 arrays read from a key-value store (``utils/ocdbt.py``), as orbax
writes each checkpoint leaf: ``<name>/.zarray`` (JSON: shape, chunks, dtype,
order, fill value, compressor, filters) and one key a chunk,
``<name>/<i>.<j>...`` (``<name>/0`` for a scalar).

Read: the dtypes ``<f4 <f8 <f2 <i4 <i8 <u4 |u1 |b1`` and ``bfloat16``, C
order, any chunk grid (edge chunks stored whole and cut), ``fill_value``
for a missing chunk, the compressor ``zstd`` or none. Any other
compressor, filter, order or separator raises, naming it. Chunks decode
through ``utils/zstd.py`` on the caller's device. A bfloat16 array comes
back as a ``torch.bfloat16`` tensor (numpy has no such dtype), every other
as a numpy array.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch

from fce_yolo_tpu_torch.utils import zstd

__all__ = ["DTYPES", "read_array"]

DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
          "<u4": np.uint32, "|u1": np.uint8, "|b1": np.bool_, "bfloat16": np.uint16}


def _fill(value, dtype: np.dtype, name: str):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special or dtype.kind != "f":
            raise ValueError(f"{name}: fill_value {value!r} is not supported")
        return special[value]
    return value


def read_array(store, name: str, device="cpu"):
    """The zarr v2 array ``name`` of ``store`` (``list``/``read``/``in``)."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')} is not 2")
    dt = meta["dtype"]
    if dt not in DTYPES:
        raise ValueError(f"{name}: dtype {dt!r} is not supported (only {', '.join(DTYPES)})")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']!r} is not supported (only 'C')")
    if meta.get("filters"):
        raise ValueError(f"{name}: filters {[f.get('id') for f in meta['filters']]} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r} is not supported (only zstd or none)")
    sep = meta.get("dimension_separator", ".")
    if sep != ".":
        raise ValueError(f"{name}: dimension_separator {sep!r} is not supported (only '.')")
    dtype = np.dtype(DTYPES[dt])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {list(chunks)} do not fit shape {list(shape)}")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, name), dtype)
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    for idx in itertools.product(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        if comp is not None:
            try:
                raw = zstd.decompress(raw, device, size_hint=chunk_bytes)
            except ValueError as e:
                raise ValueError(f"{key}: {e}") from None
        if len(raw) != chunk_bytes:
            raise ValueError(f"{key}: {len(raw)} bytes where a chunk of {list(chunks)} {dt} has {chunk_bytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    if dt == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out

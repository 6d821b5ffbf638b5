"""Safetensors-compatible tensor serialization.

The paper ships gRPC + Protobuf + Safetensors; offline we reproduce the
wire format itself: an 8-byte little-endian header length, a JSON header
mapping tensor names to {dtype, shape, data_offsets}, then the raw
buffers. This is byte-compatible with the safetensors spec (plus a
"__metadata__" entry for message routing), so payloads produced here
could be read by the reference implementation.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def encode(tensors: Dict[str, np.ndarray],
           metadata: Optional[Dict[str, str]] = None) -> bytes:
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    buffers = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.kind in ("S", "V"):
            # byte-string tensors (ids, digests, ciphertexts) ride as U8
            # with the item size recorded in metadata
            itemsize = arr.dtype.itemsize
            header.setdefault("__metadata__", {})[f"bytes:{name}"] = \
                str(itemsize)
            arr = np.frombuffer(arr.tobytes(), np.uint8).reshape(
                arr.shape + (itemsize,))
        key = _DTYPE_NAMES.get(arr.dtype)
        if key is None:
            raise TypeError(f"unsupported dtype {arr.dtype} for {name}")
        raw = arr.tobytes()
        header[name] = {"dtype": key, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode()
    pad = (8 - len(hjson) % 8) % 8          # spec: header padded with spaces
    hjson += b" " * pad
    return struct.pack("<Q", len(hjson)) + hjson + b"".join(buffers)


def decode(blob: bytes) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    (hlen,) = struct.unpack_from("<Q", blob, 0)
    header = json.loads(blob[8:8 + hlen].decode())
    base = 8 + hlen
    metadata = header.pop("__metadata__", {})
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(blob[base + lo:base + hi],
                            dtype=_DTYPES[info["dtype"]])
        arr = arr.reshape(info["shape"]).copy()
        bkey = f"bytes:{name}"
        if bkey in metadata:
            itemsize = int(metadata[bkey])
            arr = np.frombuffer(arr.tobytes(), dtype=f"S{itemsize}"
                                ).reshape(info["shape"][:-1]).copy()
        out[name] = arr
    return out, metadata


def nbytes(tensors: Dict[str, np.ndarray]) -> int:
    return sum(np.ascontiguousarray(a).nbytes for a in tensors.values())


# ---------------------------------------------------------------------------
# big-int transport (ciphertexts, blinded PSI points)
# ---------------------------------------------------------------------------
# Widths are *derived from the key size* by the sender and carried in
# message metadata — nothing on the wire is hardcoded, so 2048-bit+
# Paillier ciphertexts transport without truncation.


def int_width(n: int) -> int:
    """Bytes needed for non-negative ints < n (e.g. n = modulus)."""
    return max(1, ((n - 1).bit_length() + 7) // 8)


def ints_to_u8(vals, width: int) -> np.ndarray:
    """Non-negative big ints -> (len, width) uint8 big-endian rows."""
    buf = b"".join(int(v).to_bytes(width, "big") for v in vals)
    return np.frombuffer(buf, np.uint8).reshape(len(vals), width)


def u8_to_ints(arr: np.ndarray) -> list:
    """Inverse of ints_to_u8 for any trailing-dim width."""
    flat = np.ascontiguousarray(arr).reshape(-1, arr.shape[-1])
    data = flat.tobytes()
    w = arr.shape[-1]
    return [int.from_bytes(data[i * w:(i + 1) * w], "big")
            for i in range(flat.shape[0])]

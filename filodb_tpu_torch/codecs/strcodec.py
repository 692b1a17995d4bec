"""UTF-8 string and nbit-int vector codecs.

Capability match for the reference's UTF8Vector / DictUTF8Vector /
IntBinaryVector (reference: memory/src/main/scala/filodb.memory/format/
UTF8Vector.scala:17, DictUTF8Vector.scala:15, vectors/IntBinaryVector.scala:15).
Used by tag columns and multi-column event schemas (the GDELT-style use case).
"""

from __future__ import annotations

import struct

import numpy as np

from filodb_tpu_torch.codecs.wire import WireType

_N = struct.Struct("<I")


def encode_utf8(strings: list[bytes | str]) -> bytes:
    """Dense layout: offsets (u32[n+1]) + concatenated payload.  If the
    distinct-value ratio is low, dictionary-encode instead (reference's
    DictUTF8Vector auto-selection in optimize())."""
    bs = [s.encode() if isinstance(s, str) else s for s in strings]
    uniq = sorted(set(bs))
    if len(bs) >= 8 and len(uniq) * 2 <= len(bs):
        index = {s: i for i, s in enumerate(uniq)}
        codes = np.array([index[s] for s in bs], dtype=np.uint32)
        dict_blob = encode_utf8_dense(uniq)
        return (bytes([WireType.DICT_UTF8]) + _N.pack(len(bs)) + _N.pack(len(dict_blob))
                + dict_blob + encode_nbit(codes))
    return encode_utf8_dense(bs)


def encode_utf8_dense(bs: list[bytes]) -> bytes:
    offsets = np.zeros(len(bs) + 1, dtype=np.uint32)
    np.cumsum([len(b) for b in bs], out=offsets[1:])
    return (bytes([WireType.UTF8_DENSE]) + _N.pack(len(bs))
            + offsets.astype("<u4").tobytes() + b"".join(bs))


def decode_utf8(buf: bytes) -> list[bytes]:
    wire = buf[0]
    if wire == WireType.UTF8_DENSE:
        (n,) = _N.unpack_from(buf, 1)
        offs = np.frombuffer(buf, dtype="<u4", count=n + 1, offset=5)
        base = 5 + 4 * (n + 1)
        return [bytes(buf[base + offs[i]:base + offs[i + 1]]) for i in range(n)]
    if wire == WireType.DICT_UTF8:
        (n,) = _N.unpack_from(buf, 1)
        (dlen,) = _N.unpack_from(buf, 5)
        uniq = decode_utf8(buf[9:9 + dlen])
        codes = decode_nbit(buf[9 + dlen:])
        return [uniq[c] for c in codes]
    raise ValueError(f"not a UTF8 vector: wire type {wire}")


def encode_nbit(values: np.ndarray) -> bytes:
    """nbits-packed unsigned ints (1/2/4/8/16/32 bits per value)."""
    v = np.ascontiguousarray(values, dtype=np.uint32)
    maxv = int(v.max()) if len(v) else 0
    for nbits in (1, 2, 4, 8, 16, 32):
        if maxv < (1 << nbits):
            break
    out = bytearray([WireType.INT_NBIT, nbits])
    out += _N.pack(len(v))
    if nbits >= 8:
        out += v.astype(f"<u{nbits // 8}").tobytes()
    else:
        per_byte = 8 // nbits
        pad = (-len(v)) % per_byte
        vp = np.concatenate([v, np.zeros(pad, dtype=np.uint32)]).reshape(-1, per_byte)
        packed = np.zeros(len(vp), dtype=np.uint32)
        for k in range(per_byte):
            packed |= vp[:, k] << (k * nbits)
        out += packed.astype(np.uint8).tobytes()
    return bytes(out)


def decode_nbit(buf: bytes) -> np.ndarray:
    if buf[0] != WireType.INT_NBIT:
        raise ValueError(f"not an nbit vector: wire type {buf[0]}")
    nbits = buf[1]
    (n,) = _N.unpack_from(buf, 2)
    payload = buf[6:]
    if nbits >= 8:
        return np.frombuffer(payload, dtype=f"<u{nbits // 8}", count=n).astype(np.uint32)
    per_byte = 8 // nbits
    raw = np.frombuffer(payload, dtype=np.uint8, count=(n + per_byte - 1) // per_byte)
    mask = (1 << nbits) - 1
    out = np.empty(len(raw) * per_byte, dtype=np.uint32)
    for k in range(per_byte):
        out[k::per_byte] = (raw >> (k * nbits)) & mask
    return out[:n]

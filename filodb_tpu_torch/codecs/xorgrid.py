"""XOR-class grid codec: the compressed-resident value-plane layout.

This is the encode side of the device grid's compressed residents
(memstore/devicestore.py) and the layout contract the fused serving
kernels (ops/grid.py ``rate_grid_packed``) rely on.  It is the Gorilla
XOR-with-previous idea restated with STATIC shapes so XLA/Mosaic can
vectorize the decode (reference: queries read compressed BinaryVectors
straight from block memory, BlockManager.scala:142, doc/compression.md):

- Per lane, residual ``r`` holds ``bits[r] ^ bits[r-1]``; row 0's
  residual is stored as 0 and the full first value rides a separate
  ``first`` plane (one big row-0 residual must not widen a lane's
  class).
- Each lane is classified by the fixed width (8/16[/32] bits) that
  holds ALL its residuals after a per-lane right shift by the common
  trailing-zero count; incompressible lanes stay raw (residual form,
  bit-preserving).
- Lanes are grouped by class into contiguous sub-planes (``p8``/
  ``p16``[/``p32``]/``raw``), so decode is widen -> shift -> one
  log2(B) prefix-XOR scan down the bucket axis -> bitcast, uniformly
  across every class; ``inv`` gathers lane order back.

Layout guarantees the fused TPU kernel relies on (NEW vs the round-5
in-devicestore packer):

1. **Lane-block alignment** — every class sub-plane's lane count is a
   multiple of ``lane_block`` (default 128, the Mosaic lane tile), via
   the cheaper of promoting excess lanes to the next-wider class or
   padding with zero lanes (zero residuals + first 0.0 decode to a
   constant 0.0 column; consumers drop pad lanes through ``inv`` /
   group maps).  The widest (raw) plane can only pad.
2. **Per-plane meta tiles** (f32 planes only) — ``m8``/``m16``/
   ``mraw``: ``[8, n]`` int32 with row 0 = per-lane shift, row 1 = the
   first-row value's bits, row 2 = per-lane within-bucket phase (for
   the uniform-phase kernels; 1 when unknown), rows 3-7 zero.  8 rows
   because Mosaic DMAs sublane multiples; the kernel reads one meta
   tile next to each packed tile, so decode needs no second input
   stream per quantity.
3. **Plane order is packed order** — consumers compose their existing
   lane indirections (request lane index, group map, phase row) with
   ``inv`` (original lane -> packed position) host-side; the device
   never gathers.

The decode side lives with the kernels: ``ops/grid.py``
(``decode_packed_plane``, the packed kernels) and the multi-block decode
in ``memstore/devicestore.py``; :func:`unpack_vals` is the numpy oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

LANE_BLOCK = 128          # Mosaic lane-tile granularity every plane honors

_DTS = {8: np.uint8, 16: np.uint16, 32: np.uint32}


class PackedVals(NamedTuple):
    """One packed value plane.

    ``planes`` holds everything the device needs (class planes, shift/
    first/meta planes, ``inv``); ``inv`` rides separately as host
    metadata too (original lane -> packed position, int64) so callers
    can compose lane indirections without a device readback.
    ``nbytes`` is the resident footprint (sum of plane bytes)."""

    planes: dict
    inv: np.ndarray
    nbytes: int


def _ctz_blen(res: np.ndarray, word) -> tuple[np.ndarray, np.ndarray]:
    """Per-lane common trailing zeros of the OR-reduced residuals and
    the significant bit length after that shift."""
    L = res.shape[1]
    orv = np.bitwise_or.reduce(res, axis=0)
    nz = orv != 0
    low = orv & (~orv + word(1))
    ctz = np.zeros(L, np.int64)
    ctz[nz] = np.log2(low[nz].astype(np.float64)).astype(np.int64)
    shifted = orv >> ctz.astype(word)
    blen = np.zeros(L, np.int64)
    m = shifted.copy()
    while (m > 0).any():
        blen[m > 0] += 1
        m >>= word(1)
    return ctz, blen


# a plane this narrow may skip lane-block alignment: the fused kernel
# runs it as ONE whole-plane block (Mosaic masks sub-tile lane dims),
# and the VMEM footprint of a [B, <=1024] tile stays small.  Wider
# planes must align so the kernel can tile/pipeline them.
UNPADDED_MAX = 1024


def _align_classes(by_cls: list[list], widths: tuple, itemsize: int,
                   B: int, lane_block: int, stride: int = 1) -> list[int]:
    """Enforce guarantee 1: each class's lane count is either a
    multiple of ``lane_block`` or small enough (<= UNPADDED_MAX) to run
    as one whole-plane kernel block.  Misaligned classes take one of:
    promote the excess to the next-wider class (a narrow residual
    always fits a wider word), pad with zero lanes, or stay as-is when
    narrow.  With <= 4 classes the <= 3^4 decision combinations are
    searched exhaustively for the minimum resident bytes — a one-step
    greedy misjudges cascades (promoting into an empty raw plane would
    force an expensive raw pad).  Mutates ``by_cls`` (last slot = raw);
    returns per-class pad lane counts.

    ``stride > 1`` (histogram bucket planes) disables promotion: a
    promotable excess is rarely a whole number of ``stride``-column
    series AND congruent to the misalignment, and splitting one
    series' bucket columns across class planes would break the
    bucket-contiguity guarantee the hist kernels slice by.  Pads are
    appended zero lanes (never part of a series), so padding stays
    legal at any stride."""
    import itertools

    nbytes_of = [w // 8 for w in widths] + [itemsize]
    nc = len(by_cls)

    def simulate(choices: tuple):
        counts = [len(c) for c in by_cls]
        pads = [0] * nc
        promotes = [0] * nc
        for i in range(nc):
            rem = counts[i] % lane_block
            if rem == 0:
                continue
            pick = choices[i]
            if pick == "asis" and counts[i] > UNPADDED_MAX:
                pick = "pad"     # too wide to run unaligned
            if pick == "promote" and (i == nc - 1 or stride > 1):
                pick = "pad"     # nothing wider than raw / hist contiguity
            if pick == "promote":
                counts[i + 1] += rem
                counts[i] -= rem
                promotes[i] = rem
            elif pick == "pad":
                pads[i] = lane_block - rem
        total = sum((counts[i] + pads[i]) * nbytes_of[i] * B
                    for i in range(nc))
        return total, pads, promotes

    best = min((simulate(c) for c in
                itertools.product(("promote", "pad", "asis"), repeat=nc)),
               key=lambda t: t[0])
    _total, pads, promotes = best
    for i in range(nc - 1):
        if promotes[i]:
            by_cls[i + 1] = by_cls[i][-promotes[i]:] + by_cls[i + 1]
            del by_cls[i][-promotes[i]:]
    return pads


def pack_vals(vals: np.ndarray, lane_block: int = LANE_BLOCK,
              phase: Optional[np.ndarray] = None,
              min_width: int = 0, stride: int = 1) -> Optional[PackedVals]:
    """Pack a ``[B, L]`` f32/f64 value plane into XOR-class form.

    Returns None when compression doesn't pay (packed footprint must
    save >= 25% vs the raw value plane).  ``phase`` ([L] int32
    within-bucket scrape offsets, original lane order) rides into the
    meta tiles for the uniform-phase kernels; omit when unknown.
    ``min_width`` forces lanes that would classify narrower up to the
    given class — a workload whose residuals provably fit one width
    (e.g. the north-star integer counters) then packs as a SINGLE class
    plane, which preserves lane (and therefore group) order for the
    fused grouped kernel's contiguity contract.

    ``stride`` (histogram bucket planes, devicestore's group-slot
    layout ``hist_slot_garr``: column ``s*stride + j`` = series s,
    cumulative bucket j) packs at SERIES granularity: all ``stride``
    columns of a series classify together (widest bucket column wins)
    and stay CONTIGUOUS, in bucket order, in the packed layout — the
    guarantee the fused hist kernels (ops/grid.py
    ``hist_grid_grouped_packed``) rely on to reduce the bucket
    dimension with banded matmuls."""
    B, L = vals.shape
    if B == 0 or L == 0:
        return None
    if stride > 1 and L % stride != 0:
        raise ValueError(f"plane width {L} not a multiple of the "
                         f"bucket stride {stride}")
    itemsize = vals.dtype.itemsize
    word = np.uint32 if itemsize == 4 else np.uint64
    bits = np.ascontiguousarray(vals).view(word)
    res = bits.copy()
    res[1:] ^= bits[:-1]
    # row 0's residual is the full first value (no predecessor) — store
    # it as its own plane so one big residual can't push a whole lane
    # out of its narrow class
    res[0] = 0
    ctz, blen = _ctz_blen(res, word)
    widths = (8, 16, 32) if itemsize == 8 else (8, 16)
    if stride > 1:
        # series-granular classification: the widest bucket column of a
        # series classifies all of its columns, so the series' bucket
        # columns can never straddle a class boundary
        blen = np.repeat(blen.reshape(-1, stride).max(axis=1), stride)
    cls = np.full(L, len(widths), np.int64)            # widest = raw
    for i, w in enumerate(reversed(widths)):
        cls[blen <= w] = len(widths) - 1 - i
    if min_width:
        floor = widths.index(min_width)
        cls[cls < floor] = floor
    by_cls = [list(np.flatnonzero(cls == i)) for i in range(len(widths))]
    by_cls.append(list(np.flatnonzero(cls == len(widths))))   # raw
    pads = _align_classes(by_cls, widths, itemsize, B, lane_block,
                          stride=stride)
    # canonical order: ascending original lane within each class, so a
    # single-class pack is the IDENTITY permutation (the group-aligned
    # contract rate_grid_grouped_packed relies on)
    by_cls = [sorted(c) for c in by_cls]
    planes: dict[str, np.ndarray] = {}
    order_parts: list[np.ndarray] = []
    first_parts: list[np.ndarray] = []
    meta = itemsize == 4                 # fused kernels are f32-only
    for i, key in enumerate([f"p{w}" for w in widths] + ["raw"]):
        lanes_i = np.asarray(by_cls[i], dtype=np.int64)
        n = len(lanes_i) + pads[i]
        if n == 0:
            continue
        zl = np.zeros(n, np.int32)
        if key != "raw":          # raw residuals are stored UNSHIFTED
            zl[:len(lanes_i)] = ctz[lanes_i].astype(np.int32)
        fl = np.zeros(n, vals.dtype)
        fl[:len(lanes_i)] = vals[0, lanes_i]
        if key == "raw":
            # raw lanes store RESIDUALS too (float-viewed, bit-
            # preserving): ONE prefix-XOR scan decodes every class
            arr = np.zeros((B, n), word)
            arr[:, :len(lanes_i)] = res[:, lanes_i]
            planes["raw"] = arr.view(vals.dtype)
        else:
            w = widths[i]
            arr = np.zeros((B, n), _DTS[w])
            arr[:, :len(lanes_i)] = (res[:, lanes_i]
                                     >> ctz[lanes_i].astype(word))
            planes[key] = arr
            planes[f"z{w}"] = zl
        if meta:
            m = np.zeros((8, n), np.int32)
            m[0] = zl
            m[1, :len(lanes_i)] = np.ascontiguousarray(
                vals[0, lanes_i].astype(np.float32)).view(np.int32)
            m[2] = 1
            if phase is not None:
                m[2, :len(lanes_i)] = np.asarray(phase,
                                                 np.int32)[lanes_i]
            planes["mraw" if key == "raw" else f"m{w}"] = m
        order_parts.append(np.concatenate(
            [lanes_i, np.full(pads[i], -1, np.int64)]))
        first_parts.append(fl)
    if "raw" not in planes:
        # dtype marker for consumers that introspect the packed word
        # size; also keeps decode uniform (empty plane concatenates away)
        planes["raw"] = np.zeros((B, 0), vals.dtype)
    order = np.concatenate(order_parts)
    planes["first"] = np.concatenate(first_parts)
    inv = np.full(L, -1, np.int64)
    inv[order[order >= 0]] = np.flatnonzero(order >= 0)
    planes["inv"] = inv.astype(np.int32)
    nbytes = sum(a.nbytes for a in planes.values())
    if nbytes * 4 > B * L * itemsize * 3:              # must save >= 25%
        return None
    return PackedVals(planes, inv, nbytes)


def unpack_vals(packed) -> np.ndarray:
    """Bit-exact CPU decode of :func:`pack_vals` output (a
    :class:`PackedVals` or its ``planes`` dict) back to the original
    ``[B, L]`` plane: the oracle the kernels' decode is held to."""
    planes = getattr(packed, "planes", packed)
    raw = np.asarray(planes["raw"])
    word = np.uint32 if raw.dtype.itemsize == 4 else np.uint64
    parts = []
    for w in (8, 16, 32):
        p = planes.get(f"p{w}")
        if p is None:
            continue
        z = np.asarray(planes[f"z{w}"]).astype(word)
        parts.append(np.asarray(p).astype(word) << z[None, :])
    if raw.shape[1]:
        parts.append(np.ascontiguousarray(raw).view(word))
    u = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    u = np.bitwise_xor.accumulate(u, axis=0)
    u ^= np.ascontiguousarray(np.asarray(planes["first"])).view(word)[None, :]
    return u.view(raw.dtype)[:, np.asarray(planes["inv"])]


# torch has almost no operators on uint16/uint32: such planes ride as
# signed views of the same bits (the kernels read raw words either way)
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def signed_view(a: np.ndarray) -> np.ndarray:
    """``a`` with uint16/uint32 words viewed as int16/int32 (same bits);
    other dtypes unchanged."""
    a = np.ascontiguousarray(a)
    view = _SIGNED.get(a.dtype)
    return a.view(view) if view is not None else a


def packed_to_torch(pack, device) -> dict:
    """An XOR-class pack (a :class:`PackedVals` or its ``planes`` dict of
    numpy arrays, as :func:`pack_vals` returns it) -> the same planes as
    tensors on ``device``: the packed kernel's inputs (``p8`` uint8,
    ``p16``/``p32`` int16/int32 bit views, ``raw`` f32, ``m*`` int32
    meta tiles) plus ``first``, ``z*`` and ``inv``."""
    import torch

    planes = getattr(pack, "planes", pack)
    return {k: torch.as_tensor(signed_view(np.asarray(v))).to(device)
            for k, v in planes.items()}

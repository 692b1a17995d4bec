"""Wire-format type codes for encoded vectors.

Mirrors the *role* of the reference's vector type/subtype registry
(reference: memory/src/main/scala/filodb.memory/format/WireFormat.scala:7-37),
which tags every frozen BinaryVector with a (major, subtype) pair so readers
can be chosen at decode time.  Our encoded chunks carry a 1-byte ``WireType``
header followed by codec-specific payload.
"""

from __future__ import annotations

import enum


class WireType(enum.IntEnum):
    """Codec identifier stored as the first byte of every encoded vector."""

    # Timestamps / longs
    DELTA2 = 1          # delta-delta sloped-line model + nibble-packed residuals
    CONST_LONG = 2      # constant value or perfect line (base + slope only)
    RAW_LONG = 3        # uncompressed little-endian int64
    # Doubles
    DELTA2_DOUBLE = 16  # integral doubles encoded through the long path
    XOR_DOUBLE = 17     # previous-value XOR predictor + nibble-packed residuals
    RAW_DOUBLE = 18     # uncompressed little-endian float64
    CONST_DOUBLE = 19
    GORILLA_DOUBLE = 20  # XOR predictor + bit-level Gorilla windows (SoA)
    # Histograms
    HIST_2D_DELTA = 32  # per-row delta vs previous row, nibble-packed sections
    HIST_BLOB = 33      # single-sample BinaryHistogram blob (ingest wire form)
    # Strings / tags
    UTF8_DENSE = 48     # offsets + concatenated UTF-8 payload
    DICT_UTF8 = 49      # dictionary-encoded UTF-8
    # Ints
    INT_NBIT = 64       # nbits-packed small ints


HEADER_SIZE = 1

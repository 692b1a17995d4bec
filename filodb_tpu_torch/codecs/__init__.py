"""Columnar host codecs: encoders take dense arrays and produce compact
``bytes``; decoders take ``bytes`` and produce dense arrays ready to be
staged into device tensors.  Hot codecs have a C++ fast path
(filodb_tpu_torch/native) with these numpy implementations as the
reference."""

from filodb_tpu_torch.codecs.wire import WireType  # noqa: F401
from filodb_tpu_torch.codecs import nibblepack, deltadelta, doublecodec  # noqa: F401
from filodb_tpu_torch import native as _native_mod

_native_mod.enable()   # False without g++: the numpy codecs serve

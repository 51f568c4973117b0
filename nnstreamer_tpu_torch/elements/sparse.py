"""tensor_sparse_enc / tensor_sparse_dec: static ↔ sparse tensor format.

Parity with gst/nnstreamer/elements/gsttensor_sparseenc.c / sparsedec.c /
sparseutil.c: COO encoding — nonzero values + flat indices — carried behind
the per-buffer meta header (sparse_info.nnz, tensor_typedef.h:263-296).
Wire layout per tensor: 128-byte meta ++ values[nnz] ++ uint32 indices[nnz].
(The reference stores per-rank uint32 index tuples; we store flat uint32
indices — same information, one word per element.)  The counterpart of
``nnstreamer_tpu/elements/sparse.py``: the codec runs on the host, with
the port's native gather/scatter (:mod:`nnstreamer_tpu_torch.native`).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.element import Element
from ..pipeline.registry import register_element
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps)
from ..tensor.info import TensorInfo, TensorsConfig
from ..tensor.meta import META_HEADER_SIZE, TensorMetaInfo
from ..tensor.types import TensorFormat, dim_to_np_shape


def sparse_encode(arr: np.ndarray) -> bytes:
    """Dense → meta+values+indices blob (reference sparseutil encode loop,
    gsttensor_sparseutil.c:120-180).  Uses the native tensorwire codec when
    libnnstw.so is available."""
    from .. import native
    from ..tensor.info import TensorInfo as _TI

    vals, idx = native.sparse_gather(arr)
    meta = TensorMetaInfo.from_info(_TI.from_np(arr),
                                    format=TensorFormat.SPARSE)
    meta.sparse_nnz = int(idx.size)
    return meta.to_bytes() + vals.tobytes() + idx.tobytes()


def sparse_decode(blob: bytes) -> np.ndarray:
    """meta+values+indices blob → dense (reference sparseutil decode,
    gsttensor_sparseutil.c:31-62)."""
    meta = TensorMetaInfo.from_bytes(blob)
    nnz = meta.sparse_nnz
    esz = meta.dtype.element_size
    vals = np.frombuffer(blob, meta.dtype.np_dtype, count=nnz,
                         offset=META_HEADER_SIZE)
    idx = np.frombuffer(blob, np.uint32, count=nnz,
                        offset=META_HEADER_SIZE + nnz * esz)
    shape = dim_to_np_shape(meta.dims)
    from .. import native

    dense = native.sparse_scatter(vals, idx, int(np.prod(shape)))
    return dense.reshape(shape)


@register_element
class TensorSparseEnc(Element):
    FACTORY = "tensor_sparse_enc"

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")
        from ..tensor.caps_util import tensors_template_caps

        self.add_src_pad(tensors_template_caps(), "src")

    def set_caps(self, pad, caps):
        cfg = config_from_caps(caps)
        out = TensorsConfig(format=TensorFormat.SPARSE,
                            rate=cfg.rate or Fraction(0, 1))
        self.announce_src_caps(caps_from_config(out))

    def chain(self, pad, buf):
        blobs = [np.frombuffer(sparse_encode(buf.np(i)), np.uint8)
                 for i in range(buf.num_tensors)]
        return self.push(buf.with_tensors(blobs))


@register_element
class TensorSparseDec(Element):
    FACTORY = "tensor_sparse_dec"

    def _make_pads(self):
        from ..tensor.caps_util import tensors_template_caps

        self.add_sink_pad(tensors_template_caps(), "sink")
        self.add_src_pad(static_tensors_caps(), "src")

    def start(self):
        self._announced = False

    def set_caps(self, pad, caps):
        self._rate = config_from_caps(caps).rate

    def chain(self, pad, buf):
        dense = [sparse_decode(buf.np(i).tobytes())
                 for i in range(buf.num_tensors)]
        if not self._announced:
            from ..tensor.info import TensorsInfo

            cfg = TensorsConfig(
                info=TensorsInfo([TensorInfo.from_np(d) for d in dense]),
                rate=self._rate or Fraction(0, 1))
            self.announce_src_caps(caps_from_config(cfg))
            self._announced = True
        return self.push(buf.with_tensors(dense))

"""repro_torch.index.quant — label compression codecs (storage dtype ≠
compute dtype).

The quantization behind
:class:`repro_torch.index.store.compressed.CompressedStore`: distance
codecs (``codecs``: bf16 truncation or fixed-point u16/u32 with a
validated exactness mode) and hub-ID delta coding over the canonical
rank order (``deltas``). Everything here transforms *storage*; query
arithmetic stays f32 after a dequant on the device, so a compressed
index in exact mode answers bit-identically to a dense one.

**Standing rule:** dtype conversion of label arrays happens only here
and in ``repro_torch.index.store``; codec logic never leaks into
serve/engine code (`tests/test_torch_hygiene.py` enforces it).
"""

from repro_torch.index.quant.codecs import (DIST_CODECS, QuantizationError,
                                            QuantPrecisionError,
                                            QuantRangeError, code_array,
                                            code_tensor, decode_dist_np,
                                            decode_dist_torch, encode_dist,
                                            max_ulp_error, widen_codes)
from repro_torch.index.quant.deltas import (delta_decode_rows_np,
                                            delta_decode_rows_torch,
                                            delta_encode_rows,
                                            order_permutation)

__all__ = [
    "DIST_CODECS", "QuantizationError", "QuantPrecisionError",
    "QuantRangeError", "code_array", "code_tensor", "decode_dist_np",
    "decode_dist_torch", "delta_decode_rows_np", "delta_decode_rows_torch",
    "delta_encode_rows", "encode_dist", "max_ulp_error",
    "order_permutation", "widen_codes",
]

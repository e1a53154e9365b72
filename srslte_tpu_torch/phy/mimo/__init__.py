from .mimo import (  # noqa: F401
    alamouti_decode_2tx,
    alamouti_encode_2tx,
    equalize_mmse,
    equalize_zf,
    layerdemap_single,
    layermap_single,
    mmse_2x2,
)

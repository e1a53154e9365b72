# Frozen copy of srslte_tpu_torch/phy/mimo/__init__.py at commit e4337f4, unchanged but for this line.
from .mimo import (  # noqa: F401
    alamouti_decode_2tx,
    alamouti_encode_2tx,
    equalize_mmse,
    equalize_zf,
    layerdemap_single,
    layermap_single,
    mmse_2x2,
)

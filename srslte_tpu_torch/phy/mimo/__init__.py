from .mimo import alamouti_decode_2tx, alamouti_encode_2tx, equalize_zf  # noqa: F401

from .mimo import equalize_zf  # noqa: F401

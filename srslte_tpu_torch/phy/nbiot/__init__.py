from .sync import npss_find, npss_sequence, nsss_find, nsss_sequence

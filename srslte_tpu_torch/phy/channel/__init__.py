from .awgn import awgn, awgn_power  # noqa: F401
from .delay import fractional_delay  # noqa: F401
from .fading import FadingChannel, PROFILES  # noqa: F401
from .rlf import rlf_mask  # noqa: F401

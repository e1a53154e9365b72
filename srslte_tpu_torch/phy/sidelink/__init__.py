from .sync import psss_sequence, ssss_sequence, psss_detect, ssss_detect
from .channels import (MibSl, Psbch, Pscch, Pssch, Sci0, pack_sci0,
                       sci0_size, unpack_sci0)

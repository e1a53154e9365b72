from .am import RlcAm
from .tm import RlcTm
from .um import RlcUm
from .am_nr import (AmNrHeader, AmNrStatus, is_control_pdu, pack_am_nr,
                    pack_am_nr_status, unpack_am_nr, unpack_am_nr_status)

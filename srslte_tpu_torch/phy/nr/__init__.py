from .params import NrCarrier
from .dlsch_nr import NrDlschConfig, nr_cbsegm, nr_dlsch_decode, nr_dlsch_encode
from .pdsch_nr import NrPdsch
from .pusch_nr import NrPusch
from .ra_nr import NrGrant, nr_mcs, nr_tbs
from .dci_nr import (Dci00, Dci10, dci_00_size, dci_10_size, pack_dci_00,
                     pack_dci_10, unpack_dci_00, unpack_dci_10)
from .pdcch_nr import Coreset, NrPdcch, NrSearchSpace, pdcch_nr_locations
from .pucch_nr import NrPucch, NrPucchResource
from .uci_nr import uci_decode, uci_encode

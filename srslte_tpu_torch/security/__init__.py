from .ciphers import (cipher_decrypt, cipher_encrypt, integrity_mac,
                      EEA0, EEA1, EEA2, EEA3, EIA1, EIA2, EIA3)
from .milenage import milenage_f1, milenage_f2345

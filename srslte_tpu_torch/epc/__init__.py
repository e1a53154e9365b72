from .hss import Hss, Subscriber
from .mme import Mme
from .spgw import Spgw

from .am import RlcAm
from .tm import RlcTm
from .um import RlcUm

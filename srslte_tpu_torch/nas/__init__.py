from .keys import kdf_kasme, kdf_nas_keys, kdf_kenb
from .messages import (AttachAccept, AttachComplete, AttachRequest,
                       AuthRequest, AuthResponse, SecurityModeCommand,
                       SecurityModeComplete, nas_pack, nas_unpack)

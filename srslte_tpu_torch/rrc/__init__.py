from .messages import (ConnectionReconfiguration, ConnectionReconfigurationComplete,
                       ConnectionRequest, ConnectionSetup, ConnectionSetupComplete,
                       DlInformationTransfer, RrcSecurityModeCommand,
                       RrcSecurityModeComplete, Sib1, UlInformationTransfer,
                       rrc_pack, rrc_unpack)

from .pdu import MacPdu, MacSubPdu, RarPdu, Rar, DL_LCID, UL_LCID

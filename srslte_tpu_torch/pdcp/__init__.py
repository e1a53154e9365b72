from .entity import PdcpConfig, PdcpEntity

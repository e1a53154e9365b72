"""S1AP over ALIGNED PER (36.413) — reference: lib/src/asn1/s1ap.cc."""

from .messages import PROCEDURES, s1ap_pack, s1ap_unpack  # noqa: F401

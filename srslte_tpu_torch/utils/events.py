"""eNB structured event logging (enb_events.cc equivalent).

Reference behavior: lib/src/common/enb_events.cc — JSON event records with
a "type": "event" tag, carrier index, and per-kind payloads: rrc_* state
events, S1 context create/delete, sector start/stop, measurement reports,
RLF.  Here events are JSON-lines to a file and/or an in-memory ring the
tests and metrics hub can read.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class EventLog:
    """JSON-lines event sink; None path = in-memory only."""

    path: str | None = None
    keep: int = 1024
    events: list = field(default_factory=list)

    def __post_init__(self):
        self._f = open(self.path, "a") if self.path else None

    def _emit(self, name: str, **data):
        rec = {"type": "event", "timestamp": time.time(), "event_name": name,
               **data}
        self.events.append(rec)
        if len(self.events) > self.keep:
            del self.events[: len(self.events) - self.keep]
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    # -- the enb_events.cc surface ------------------------------------------
    def rrc_event(self, cc_idx: int, rnti: int, event: str, asn1: str = ""):
        """event in {connected, reconfigured, handover, reestablished,
        released} (log_rrc_event)."""
        self._emit("rrc_" + event, cc_idx=cc_idx, rnti=rnti, asn1=asn1)

    def s1_ctx_create(self, cc_idx: int, mme_id: int, enb_id: int, rnti: int):
        self._emit("s1_context_create", cc_idx=cc_idx, mme_ue_s1ap_id=mme_id,
                   enb_ue_s1ap_id=enb_id, rnti=rnti)

    def s1_ctx_delete(self, cc_idx: int, mme_id: int, enb_id: int, rnti: int):
        self._emit("s1_context_delete", cc_idx=cc_idx, mme_ue_s1ap_id=mme_id,
                   enb_ue_s1ap_id=enb_id, rnti=rnti)

    def sector_start(self, cc_idx: int, pci: int, cell_id: int):
        self._emit("sector_start", cc_idx=cc_idx, pci=pci, cell_id=cell_id)

    def sector_stop(self, cc_idx: int, pci: int, cell_id: int):
        self._emit("sector_stop", cc_idx=cc_idx, pci=pci, cell_id=cell_id)

    def measurement_report(self, cc_idx: int, rnti: int, asn1: str = ""):
        self._emit("measurement_report", cc_idx=cc_idx, rnti=rnti, asn1=asn1)

    def rlf(self, cc_idx: int, rnti: int, asn1: str = ""):
        self._emit("rlf_report", cc_idx=cc_idx, rnti=rnti, asn1=asn1)

    def of_kind(self, name: str) -> list:
        return [e for e in self.events if e["event_name"] == name]

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

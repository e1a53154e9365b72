"""RRC measurement event evaluation (36.331 §5.5.4, rrc_meas.cc equivalent).

Reference behavior: srsue/src/stack/rrc/rrc_meas.cc — for each configured
report config, evaluate the entering/leaving conditions with hysteresis,
run the timeToTrigger clock per cell, maintain the cells-triggered list,
and emit measurement reports.  Events:

  A1: serving becomes better than threshold   (Ms - Hys > Thresh)
  A2: serving becomes worse than threshold    (Ms + Hys < Thresh)
  A3: neighbour better than serving by offset (Mn - Hys > Ms + Off)
  A4: neighbour becomes better than threshold (Mn - Hys > Thresh)
  A5: serving worse than t1 AND neighbour better than t2

Leaving conditions flip the hysteresis sign; a cell leaves the triggered
list when its leaving condition holds for timeToTrigger.  Quantities are
dB/dBm floats as produced by phy/ue/intra_measure.py.

This is host-side control logic (like the reference's): the heavy lifting
(per-cell RSRP/RSRQ from CRS) is the batched PHY IntraMeasure path.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ReportConfig:
    event: str  # 'a1' | 'a2' | 'a3' | 'a4' | 'a5'
    hysteresis_db: float = 0.0
    time_to_trigger_ms: int = 0
    a3_offset_db: float = 0.0  # a3
    threshold_dbm: float = 0.0  # a1/a2/a4
    threshold1_dbm: float = 0.0  # a5 serving
    threshold2_dbm: float = 0.0  # a5 neighbour


@dataclass
class MeasReport:
    meas_id: int
    event: str
    serving_rsrp: float
    triggered: dict  # pci -> rsrp of cells satisfying the event


@dataclass
class _CellState:
    entering_ms: int = 0  # time the entering condition has held
    leaving_ms: int = 0
    triggered: bool = False


@dataclass
class MeasEventEngine:
    """Evaluates one measId's report config against periodic PHY results."""

    meas_id: int
    cfg: ReportConfig
    _cells: dict = field(default_factory=dict)  # pci (or -1 serving) -> state

    def _conds(self, ms: float, mn: float | None):
        """-> (entering, leaving) booleans for one cell."""
        c, h = self.cfg, self.cfg.hysteresis_db
        if c.event == "a1":
            return ms - h > c.threshold_dbm, ms + h < c.threshold_dbm
        if c.event == "a2":
            return ms + h < c.threshold_dbm, ms - h > c.threshold_dbm
        if c.event == "a3":
            return (mn - h > ms + c.a3_offset_db,
                    mn + h < ms + c.a3_offset_db)
        if c.event == "a4":
            return mn - h > c.threshold_dbm, mn + h < c.threshold_dbm
        if c.event == "a5":
            enter = (ms + h < c.threshold1_dbm
                     and mn - h > c.threshold2_dbm)
            leave = (ms - h > c.threshold1_dbm
                     or mn + h < c.threshold2_dbm)
            return enter, leave
        raise ValueError(f"unknown event {self.cfg.event}")

    def tick(self, serving_rsrp: float, neighbors: dict,
             dt_ms: int) -> MeasReport | None:
        """Advance TTT clocks by dt_ms; return a report on new triggers.

        neighbors: pci -> rsrp (dBm).  Serving-only events (a1/a2) track a
        single pseudo-cell.
        """
        cells = ({-1: serving_rsrp} if self.cfg.event in ("a1", "a2")
                 else dict(neighbors))
        new_trigger = False
        for pci, mn in cells.items():
            st = self._cells.setdefault(pci, _CellState())
            enter, leave = self._conds(serving_rsrp,
                                       None if pci == -1 else mn)
            if not st.triggered:
                st.entering_ms = st.entering_ms + dt_ms if enter else 0
                if enter and st.entering_ms >= self.cfg.time_to_trigger_ms:
                    st.triggered = True
                    st.leaving_ms = 0
                    new_trigger = True
            else:
                st.leaving_ms = st.leaving_ms + dt_ms if leave else 0
                if leave and st.leaving_ms >= self.cfg.time_to_trigger_ms:
                    st.triggered = False
                    st.entering_ms = 0
        # cells no longer measured leave the triggered list
        for pci in list(self._cells):
            if pci not in cells:
                del self._cells[pci]
        if not new_trigger:
            return None
        trig = {pci: cells[pci] for pci, st in self._cells.items()
                if st.triggered and pci != -1}
        return MeasReport(self.meas_id, self.cfg.event, serving_rsrp, trig)

    @property
    def triggered_cells(self) -> tuple:
        return tuple(p for p, st in self._cells.items()
                     if st.triggered and p != -1)

"""The benchmark's yardstick: cells found by name, the stimulus pool, the
window, the trace's reduction, the roofline arithmetic and the check."""

"""Host utilities of the full-stack apps (the event log)."""

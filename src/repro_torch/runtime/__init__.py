"""Runtime machinery of the port (``repro.runtime``'s counterpart)."""

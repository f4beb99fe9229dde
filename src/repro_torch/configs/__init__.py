"""Engine configurations of the port (``shareddb_tpcw``: the paper's own)."""

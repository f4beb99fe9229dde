"""Workloads of the port (``tpcw``: the paper's TPC-W evaluation)."""

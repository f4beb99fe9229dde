"""Shared group-by phase 1's least work in a beat (every flavour runs it):
one launch a group-by stage over the bounded union of its spine's wanted
rows (``GROUP_UNION_CAP`` rows at most, the plan's bound), each row's
group code, value and query words read once, and the count and sum of
every group and query written once (2 x 4 B).

``least_s(dep, flavour)``: (seconds, the rates that bound its
launches) of one beat of ``flavour``; ``dep`` holds the deployment's
``tables``, ``templates`` and ``dense_pk_index``.
"""
from bench.roofline import _stages, peaks

SYMBOL = "groupby_kernel"
GROUP_UNION_CAP = 16384


def least_s(dep, flavour: str):
    stages = {}
    for t in dep.templates.values():
        if t.group:
            stages.setdefault((t.spine, t.group, t.agg), []).append(t)
    total, bounds = 0.0, set()
    for (spine, _, _), ts in stages.items():
        rows = min(dep.tables[spine].capacity, GROUP_UNION_CAP)
        Q = sum(t.cap for t in ts)
        G = max(t.n_groups for t in ts)
        nbytes = rows * (8 + 4 * _stages.words(Q)) + 2 * 4 * G * Q
        s, bound = peaks.least_s(nbytes, 0)
        total += s
        bounds.add(bound)
    return total, " and ".join(sorted(bounds)) or None

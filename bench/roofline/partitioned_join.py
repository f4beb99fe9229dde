"""The partitioned join's least work in a full-probe beat: one launch a
join into an index-less PK table. Bytes: the left keys, the left query
words of the join's subscribers, the right side's key partitions (key
and row, 8 B a right row), the right query words, and the row ids and
combined words written. Operations: a binary search of the right side a
left row (compares, log2 of its rows).

``least_s(dep, flavour)``: (seconds, the rates that bound its
launches) of one beat of ``flavour``; ``dep`` holds the deployment's
``tables``, ``templates`` and ``dense_pk_index``.
"""
import math

from bench.roofline import _stages, peaks

SYMBOL = "partitioned_join_kernel"


def least_s(dep, flavour: str):
    if flavour == "delta_join" or dep.dense_pk_index:
        return 0.0, None
    total, bounds = 0.0, set()
    for (spine, _, pk), ts in _stages.joins(dep.templates).items():
        Tl, Tr = dep.tables[spine].capacity, dep.tables[pk].capacity
        w = _stages.words(sum(t.cap for t in ts))
        nbytes = Tl * 4 + Tl * w * 4 + Tr * 8 + Tr * w * 4 \
            + Tl * 4 + Tl * w * 4
        nops = Tl * math.ceil(math.log2(Tr))
        s, bound = peaks.least_s(nbytes, nops)
        total += s
        bounds.add(bound)
    return total, " and ".join(sorted(bounds)) or None

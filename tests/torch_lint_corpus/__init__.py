"""Seeded-mutation corpus for the port's planlint
(tests/test_torch_planlint.py), the counterpart of ``tests/lint_corpus``.

Each module plants ONE class of bug the port's static verifier must
catch: ``EXPECT`` names the rule id that must fire, and ``findings(ctx)``
builds the mutated artifact and runs the relevant pass against it.
``ctx`` is the test module's fixture dict (the index-less plan at tiny
scale, its key stats, lowered IR, fused geometry and the descriptor
``launch_schedule`` builds for it, and a CPU engine with its recorded
beats).  A mutation that stops producing its rule id means the verifier
regressed, not the corpus.
"""

CORPUS = (
    "overlapping_slots",
    "off_by_one_schedule",
    "oob_gather",
    "double_writer",
    "full_width_compare",
    "aliased_result_buffers",
    "donated_rid_carry",
)

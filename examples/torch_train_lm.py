"""Train a reduced-config LM end to end on the PyTorch/CUDA port with the
full substrate: data pipeline, AdamW, atomic checkpointing, the
fault-tolerant loop (an injected mid-run failure and a bit-exact resume
from the last checkpoint).

    PYTHONPATH=src python examples/torch_train_lm.py [arch] [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.launch import train

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="mamba2-370m")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

FAIL_AT = 25        # between the checkpoints of steps 20 and 30
ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
try:
    log = train.main(["--arch", args.arch, "--smoke", "--steps", "40",
                      "--batch", "8", "--seq", "64", "--ckpt", ckpt,
                      "--save-every", "10"]
                     + (["--device", args.device] if args.device else []),
                     fail_at={FAIL_AT: RuntimeError("injected failure")})
    steps = [m["step"] for m in log]
    # the loop rolled back to the checkpoint of step 20 and replayed
    first = {m["step"]: m["loss"] for m in log[:FAIL_AT]}
    replay = log[FAIL_AT:FAIL_AT + FAIL_AT - 20]
    assert steps[:FAIL_AT] == list(range(FAIL_AT)) and steps[-1] == 39
    assert [m["step"] for m in replay] == list(range(20, FAIL_AT))
    assert all(m["loss"] == first[m["step"]] for m in replay), \
        "the replay from the checkpoint differs from the first pass"
    losses = [m["loss"] for m in log]
    assert losses[-1] < losses[0], "loss did not improve"
    print(f"\nfailure injected at step {FAIL_AT}: resumed from the step-20 "
          f"checkpoint, steps 20-{FAIL_AT - 1} replayed bit for bit")
    print(f"loss improved {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints in {ckpt} (atomic, keep-last-3)")
finally:
    shutil.rmtree(ckpt, ignore_errors=True)

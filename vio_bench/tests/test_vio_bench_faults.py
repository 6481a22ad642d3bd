"""The harness's check of ``correct`` against a broken timed path, on the CPU
(about 3 minutes on 6 threads; run from the root of the repo:
``python -m pytest vio_bench/tests/test_vio_bench_faults.py``).

Each case drives a whole run of a cell (everything but the look for a
card) with the program changed underneath as ``control.ARMS`` says, and
sees ``correct`` come out false; the sound arm sees it true. The faults a
cell can have: a step that returns its state unchanged, an answer altered
where it is produced. The cells run on one card, so no exchange between
cards can be left out, and on no batch that half of it could be left out
of. The replay runs at chunk 5 and 3 s recordings, and judges a few frames
more than its short window holds, so the checks' frames past the window
are driven too."""

from __future__ import annotations

import pytest
import torch

from vio_bench import control

R = "tumvi_room_512.replay_chunk25"
SMALL = {R: ({"chunk_size": 5, "recording_s": 3.0, "check_frames": 20}, 8.0)}
# The solve whose pose the pose_altered arm moves: the runs are short here, so
# the first one the window serves.
ALTER_AT = {R: 15}
CASES = [(R, "sound"), (R, "state_unchanged"), (R, "pose_altered")]
SEED = 2 ** 31 + 11


@pytest.mark.parametrize("workload,arm", CASES, ids=[f"{w.split('.')[1]}-{a}" for w, a in CASES])
def test_correct_catches_the_fault(workload, arm):
    torch.set_num_threads(6)
    update, seconds = SMALL[workload]
    try:
        out = control.run_arm(workload, SEED, seconds, arm, device="cpu", traffic_update=update,
                              alter_at=ALTER_AT[workload])
    except RuntimeError as e:            # a run the fault stops has failed too
        assert arm != "sound", e
        return
    print(out)
    assert out["correct"] == (arm == "sound"), out

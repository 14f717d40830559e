#!/usr/bin/env python3
"""Run phase 19c of ``chip_smoke.py`` from one tree of the repo, on one card.

    python3 tools/train_phi4_step.py TREE

``TREE`` is the root of a checkout (``.``, or an older commit unpacked with
``git archive`` into a directory ``.gitignore`` lists, such as
``build/parent``): its ``src/`` and its ``chip_smoke.py`` are put first on
the path, its kernels built, and its 19c run (phi4-mini-3.8b at full width
and depth, bf16, eager steps against the sealed step's replays).  The last
line is ``PAIR {json}`` with the tree, ms per eager step and per replay
(host clock), one replay on CUDA events, the peak memory, and the kernels
of one profiled replay and their device time.  Two trees
are compared in one call, in turns: parent, change, change, parent.
Numbers from this script are the card's only when it runs there.
"""

import json
import sys

tree = sys.argv[1]
sys.path[:0] = [f"{tree}/src", tree]
import chip_smoke as c  # noqa: E402

c.phase_device()
c.phase_build()
r = c.train_phi4()
keys = ("eager_ms", "replay_ms", "replay_device_ms", "eager_peak_gib", "seal_peak_gib",
        "replay_kernel_ms", "replay_kernels")
print("PAIR " + json.dumps({"tree": tree, **{k: r[k] for k in keys}}), flush=True)

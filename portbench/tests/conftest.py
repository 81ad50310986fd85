"""The benchmark's own tests: CPU, small sizes. ``python -m pytest
portbench/tests -q`` from the repository root; the test marked ``cuda``
runs one short cell on the card and skips without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the configurations at sizes a test run holds
SMALL = {
    "plate_j2_voce_p2q_128x256": {"nx": 3, "ny": 6, "fused_step": {"n_newton": 16, "n_cg": 3000, "cg_rtol": 1e-6,
                                                                  "pc": "two_level", "pc_boxes": 2}},
    "points_j2_2m": {"n_points": 2048},
}

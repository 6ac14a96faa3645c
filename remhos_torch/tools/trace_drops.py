"""How often a `torch.profiler` capture loses the port's kernel records.

Takes `utils.trace.capture_trace` captures of n back-to-back calls of the
neighbour gather (kernel 7, the shortest kernel) on the 2D 16x16 p=3
operator, in f32 and f64, for n in N_CALLS, with each quiet gap of QUIETS
at the start of the recorded cycle, in turns; 100 more calls and a
synchronize precede each capture, as in a timed check. A capture whose
gather events differ from the launch counter's advance in the recorded
cycle is a drop. Prints one JSON line: for each gap the captures taken and
dropped, with the card and the torch version.

    python -m remhos_torch.tools.trace_drops      (TRACE_DROPS_ROUNDS=150)
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import bench, ops, resolve_device, synchronize
from ..ops import gather_nbr as gn
from ..utils import trace as trc

QUIETS = (0.0, 0.002, 0.010)
N_CALLS = (10, 100)


def main(device=None, rounds=None) -> dict:
    dev = resolve_device(device)
    if rounds is None:
        rounds = int(os.environ.get("TRACE_DROPS_ROUNDS", "150"))
    case = bench.build_case(16, 3, torch.float32, dev, n_steps=4, dim=2)
    rng = np.random.default_rng(0)
    calls = []
    for adv in (case.adv, case.adv64):
        lay = gn.GatherLayout(tuple(adv.shape), tuple(adv.periodic),
                              adv.disc.dofmaps.nbr_dof_local, dev)
        u = torch.as_tensor(
            rng.standard_normal((adv.x0_nodes.shape[0], adv.disc.nd)),
            dtype=adv.dtype, device=dev)
        calls.append(lambda u=u, lay=lay: gn.gather_nbr(u, lay))
    out = {str(q): {"captures": 0, "dropped": 0} for q in QUIETS}
    for _ in range(rounds):
        for call in calls:
            for n in N_CALLS:
                for q in QUIETS:
                    for _ in range(100):
                        call()
                    synchronize(dev)
                    before = ops.launch_counts()["gather_nbr"]
                    tr = trc.capture_trace(
                        lambda: [call() for _ in range(n)], quiet_s=q)
                    # the warm-up cycle launched as many as the recorded one
                    launched = (ops.launch_counts()["gather_nbr"] - before) // 2
                    rec = out[str(q)]
                    rec["captures"] += 1
                    rec["dropped"] += (trc.kernel_events(tr)["gather_nbr"]
                                       != launched)
    res = {"device": bench.device_line(dev), "torch": torch.__version__,
           "rounds": rounds, "quiet_s": out}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()

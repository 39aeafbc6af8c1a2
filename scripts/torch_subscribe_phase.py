#!/usr/bin/env python3
"""Phase 18 of `chip_smoke.py` alone, on one GPU: standing queries over
the live layer at the smoke's sizes, with B1-B5's launch counts read
around it.

    python3 scripts/torch_subscribe_phase.py

Builds the CUDA kernels of the checkout first (one nvcc each, in
parallel), then runs `chip_smoke.subscribe_phase` with every gate of the
full smoke. Prints the phase's lines, its {"subscribe": ...} JSON line,
the lanes' {"device_ops": ...} line and the card's name and power limit
last. Exits 1 without a CUDA device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_subscribe_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from geomesa_tpu_torch.engine.kernels import build

    card_s = cs.card()
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build in {time.perf_counter() - t0:.2f} s [{card_s}]")
    cs.subscribe_phase(torch, torch.device("cuda"), card_s)
    cs.log(f"phase-18 launches: {cs.SUB_LAUNCHES}")
    print(json.dumps({"subscribe": cs.PHASES["subscribe"]}))
    print(json.dumps({"device_ops": cs.SUB_OPS}))
    print(card_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Phase 17 of `chip_smoke.py` alone, on one GPU: the key-value index
store, the live layer and the lambda store at the smoke's sizes, with
B1-B5's launch counts read around it.

    python3 scripts/torch_kv_live_phase.py

Builds the CUDA kernels of the checkout first (one nvcc each, in
parallel), then runs `chip_smoke.kv_live_phase` with every gate of the
full smoke. Prints the phase's lines, its {"kv_live": ...} JSON line and
the card's name and power limit last. Exits 1 without a CUDA device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kv_live_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from geomesa_tpu_torch.engine.kernels import build

    card_s = cs.card()
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"build in {time.perf_counter() - t0:.2f} s [{card_s}]")
    cs.kv_live_phase(torch, torch.device("cuda"), card_s)
    cs.log(f"phase-17 launches: {cs.KVL_LAUNCHES}")
    assert all(cs.KVL_LAUNCHES.values()), cs.KVL_LAUNCHES
    print(json.dumps({"kv_live": cs.PHASES["kv_live"]}))
    print(card_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())

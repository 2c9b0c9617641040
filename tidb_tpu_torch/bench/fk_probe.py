"""Time the FOREIGN KEY membership probe two ways at TPC-H's shape.

The probe is the one the constraint phase of chip_smoke.py runs: orders'
keys less RF2's (the 1,500 x sf smallest), searched for every
l_orderkey of lineitem (6M x sf rows, drawn as ``gen_lineitem`` draws
them) by ON DELETE CASCADE, and for RF1's new line items (about 4 per
new order) by the child-side check of an INSERT. Each is timed

- ``table``: a dense lookup table over the key range, built from the
  sorted keys and then indexed (``dense_lut`` + ``in_sorted``; the build
  is in the time);
- ``search``: the binary search alone (``in_sorted`` without a table);
- ``keyset``: ``KeySet.contains`` as the port runs it, which picks
  between the two by the probe's size.

Every run's mask is checked against the search's. Prints the host's
seconds per probe as one JSON line (the card's name and power limit
beside them where ``nvidia-smi`` answers).

    python3 -m tidb_tpu_torch.bench.fk_probe [--sf 10] [--runs 3]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

from tidb_tpu_torch.session.constraints import KeySet, dense_lut, in_sorted


def _card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def probe_times(sf: float, runs: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n_orders = int(1_500_000 * sf)
    okeys = np.arange(1, n_orders + 1, dtype=np.int64)
    rf2 = okeys[:max(int(1_500 * sf), 1)]
    lineitem = rng.integers(1, n_orders + 1, int(6_000_000 * sf))
    rf1 = rng.integers(1, n_orders + 1, 4 * len(rf2))
    out = {}
    for name, values in (("cascade", lineitem), ("insert", rf1)):
        want = in_sorted(okeys, values) & ~in_sorted(rf2, values)
        ways = {
            "table": lambda: (in_sorted(okeys, values, dense_lut(okeys))
                              & ~in_sorted(rf2, values, dense_lut(rf2))),
            "search": lambda: in_sorted(okeys, values) & ~in_sorted(rf2, values),
            "keyset": lambda: KeySet(okeys, rf2).contains(values),
        }
        row = {"keys": len(okeys), "values": len(values)}
        for way, fn in ways.items():
            secs = []
            for _ in range(runs):
                t0 = time.perf_counter()
                got = fn()
                secs.append(time.perf_counter() - t0)
                assert np.array_equal(got, want), (name, way)
            row[f"{way}_s"] = secs
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps({"sf": args.sf, "card": _card(), **probe_times(args.sf, args.runs)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Wall-cycle accounting — PyTorch-port copy of
gromacs_fep_gpu_tpu/utils/timing.py (Wallcycle; reference:
src/gromacs/timing/wallcycle.cpp:483,759 — region counters printed as the
run performance table).  Regions are timed on the host clock: on the card
a region that ends at a host read of device data (the runner's list flags)
includes the device work queued before it, and one that only launches
work does not."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class Wallcycle:
    def __init__(self):
        self.t: Dict[str, float] = defaultdict(float)
        self.n: Dict[str, int] = defaultdict(int)
        self._start = time.time()

    @contextlib.contextmanager
    def region(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] += time.perf_counter() - t0
            self.n[name] += 1

    def report(self) -> str:
        total = time.time() - self._start
        lines = ["", " R E A L   C Y C L E   A N D   T I M E   A C C O U N T I N G",
                 "", f" {'Activity':<24}{'Count':>10}{'Seconds':>12}{'%':>8}"]
        for k in sorted(self.t, key=lambda k: -self.t[k]):
            lines.append(f" {k:<24}{self.n[k]:>10}{self.t[k]:>12.3f}"
                         f"{100.0 * self.t[k] / max(total, 1e-9):>8.1f}")
        lines.append(f" {'total wall':<24}{'':>10}{total:>12.3f}{100.0:>8.1f}")
        return "\n".join(lines)
